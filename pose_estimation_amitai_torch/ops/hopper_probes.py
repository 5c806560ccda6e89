"""Probe kernels: small Hopper kernels and their plain versions.

Counterparts of the Pallas probes of ``scripts/exp_im2col_bisect.py``
(``run_case`` with the bodies ``k_copy``, ``k_stage``, ``k_dyn_read``,
``k_reshape``, ``k_concat_dot``; ``run_full`` with ``full_kernel``) and of
``scripts/exp_mosaic_probe.py`` (``probe_int8_vector_arith``,
``probe_grid``, ``probe_int8_vector_in_grid``), under the scripts' names:

* :func:`k_copy`, :func:`k_stage`, :func:`k_dyn_read`, :func:`k_reshape` —
  identity copies of an int8 (B, H, W, C) frame: direct, and three ways
  through a zero-filled shared-memory tile with a halo of 2 (read back whole;
  in bands at a run-time offset with the column halo; the same through a flat
  pixel index);
* :func:`k_concat_dot` — a 9-tap dilation-2 SAME int8 conv with all-ones
  (9 * C, C) weights, clipped to +-127;
* :func:`full_epilogue` — ``full_kernel``: the single int8 conv of
  ``hopper_qconv.quantized_conv3x3`` with a requant of 64 on (9 * C, C)
  weights, im2col int8 or packed by ``pack_qconv_weights``, whatever the
  batch (the script's grid 1 and 4);
* :func:`int8_vector_arith` — ``a * 2 + b`` in int8, wrapping;
* :func:`grid_scale` — ``x * 2.0`` on (n, rows, cols) float32, one block
  per slab (``probe_grid``);
* :func:`int8_vector_in_grid` — ``int8(((int32)x * 3 + 7) >> 2)`` on
  (n, rows, cols) int8, one block per slab.

On a CUDA tensor each launches ``csrc/probes.cu`` (``full_epilogue``:
``csrc/qconv_stage.cu``); on a CPU tensor it runs its ``*_plain`` version.
Nothing falls back from one to the other. Every kernel equals its plain
version, every element.

Each probe of ``csrc/probes.cu`` has two kernels, and a rule on the operands
chooses: ``"vec16"`` moves 16 bytes a thread (the staged ones need C a
multiple of 16, all need 16-byte aligned operands), ``"byte"`` one element
a thread and takes every operand. :func:`probe_kernel_for` is the staged
probes' rule, :func:`flat_kernel_for` the others'. ``<probe>_on(kernel,
...)`` runs the kernel the caller names: the rule's, or ``"byte"``. Each
launch adds one to ``<probe>.launches`` and to
``<probe>.launches_by_kernel[kernel]``.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from . import _build
from .hopper_conv import check_operand
from .hopper_qconv import quantized_conv3x3, quantized_conv3x3_plain
from .int8_conv import conv_s32

KERNEL_CODES = {"byte": 0, "vec16": 1}  # csrc/probes.cu: KERNEL_BYTE, KERNEL_VEC16
MAX_C = 64  # channels of a staged tile
BAND = 4  # rows of a band of k_dyn_read and k_reshape


# ---------------------------------------------------------------------------
# the scripts' inputs
# ---------------------------------------------------------------------------
def run_case_input(device) -> torch.Tensor:
    """``run_case``'s frame: (1, 192, 192, 64) int8 in [-80, 80), seed 0."""
    x = np.random.default_rng(0).integers(-80, 80, (1, 192, 192, 64))
    return torch.from_numpy(x.astype(np.int8)).to(device)


def run_full_inputs(grid_b: int, device) -> tuple[torch.Tensor, ...]:
    """``run_full``'s x, w (9 * 64, 64), mult and bias, seed 0."""
    rng = np.random.default_rng(0)
    x = rng.integers(-80, 80, (grid_b, 192, 192, 64)).astype(np.int8)
    w = rng.integers(-90, 90, (9 * 64, 64)).astype(np.int8)
    m = rng.uniform(5e-4, 2e-3, (64,)).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, (64,)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x, w, m, b))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def k_copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


k_stage_plain = k_dyn_read_plain = k_reshape_plain = k_copy_plain


def k_concat_dot_plain(x: torch.Tensor) -> torch.Tensor:
    """The exact library conv with all-ones weights, clipped to +-127."""
    c = x.shape[-1]
    ones = torch.ones((3, 3, c, c), dtype=torch.int8, device=x.device)
    return conv_s32(x, ones, 2).clamp(-127, 127).to(torch.int8).contiguous()


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """(9 * C, Cout) im2col weights, row = tap * C + ci -> (3, 3, C, Cout);
    packed int32 weights as they are."""
    if w.dtype == torch.int32:
        return w
    return w.reshape(3, 3, w.shape[0] // 9, w.shape[1])


def full_epilogue_plain(x, w, mult, bias) -> torch.Tensor:
    return quantized_conv3x3_plain(x, _hwio(w), mult, bias, inv_out=64.0)


def int8_vector_arith_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(int32(a) * 2 + int32(b))`` cast back to int8, which wraps."""
    return (a.int() * 2 + b.int()).to(torch.int8)


def grid_scale_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def int8_vector_in_grid_plain(x: torch.Tensor) -> torch.Tensor:
    """``>>`` on int32 is an arithmetic shift, as in the probe."""
    return ((x.int() * 3 + 7) >> 2).to(torch.int8)


# ---------------------------------------------------------------------------
# which kernel
# ---------------------------------------------------------------------------
def probe_kernel_for(x: torch.Tensor) -> str:
    """The kernel of a staged probe (:func:`k_stage`, :func:`k_dyn_read`,
    :func:`k_reshape`, :func:`k_concat_dot`) on the (B, H, W, C) int8 ``x``:
    ``"vec16"`` where C is a multiple of 16 and ``x`` starts on a 16-byte
    boundary (so does every pixel then), else ``"byte"``."""
    return "vec16" if x.shape[-1] % 16 == 0 and x.data_ptr() % 16 == 0 else "byte"


def flat_kernel_for(*operands: torch.Tensor) -> str:
    """The kernel of :func:`k_copy` and of the Mosaic script's probes:
    ``"vec16"`` where every operand starts on a 16-byte boundary (a scalar
    head and tail take any length), else ``"byte"``."""
    for t in operands:
        if t.data_ptr() % 16:
            return "byte"
    return "vec16"


def _check_kernel(wrapper, kernel: str, ruled: str) -> None:
    if kernel != "byte" and kernel != ruled:
        raise ValueError(f"{wrapper.__name__}: kernel {kernel!r} does not take "
                         f"these operands (the rule names {ruled!r})")


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------
_FNS = None  # the library's typed entry points, resolved at the first launch


def _fns() -> SimpleNamespace:
    """``csrc/probes.cu``'s entry points with their argument types, and
    PyTorch's getter of a device's current raw stream (CUDA builds only)."""
    global _FNS
    if _FNS is None:
        lib = _build.load("probes")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fns = {}
        for name, args in (("copy", [p, p, ll]),
                           ("staged", [i, p, p, i, i, i, i, i]),
                           ("int8_axpb", [p, p, p, ll]),
                           ("grid_scale", [p, p, i, i]),
                           ("int8_in_grid", [p, p, i, i])):
            fn = getattr(lib, "pe_probe_" + name)
            fn.argtypes = [i, *args, i, p]  # kernel, ..., device, stream
            fn.restype = ctypes.c_int
            fns[name] = fn
        _FNS = SimpleNamespace(stream=torch._C._cuda_getCurrentRawStream, **fns)
    return _FNS


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, dim: int) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: on {x.device}, expected a CUDA tensor")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if x.dim() != dim or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{name}: must be contiguous, non-empty, {dim}-D")


def _launch(wrapper, kernel: str, entry: str, like: torch.Tensor, *args) -> None:
    """Run ``pe_probe_<entry>(kernel, *args, device, stream)`` on like's
    device and its current stream; count the launch on ``wrapper``."""
    fns = _fns()
    dev = like.get_device()
    rc = getattr(fns, entry)(KERNEL_CODES[kernel], *args, dev, fns.stream(dev))
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel {kernel}: CUDA error {rc}")
    wrapper.launches += 1
    wrapper.launches_by_kernel[kernel] += 1


def k_copy(x: torch.Tensor) -> torch.Tensor:
    """Identity copy of an int8 tensor."""
    if x.is_cpu:
        return k_copy_plain(x)
    return _k_copy(flat_kernel_for(x), x)


def k_copy_on(kernel: str, x: torch.Tensor) -> torch.Tensor:
    """:func:`k_copy` on the kernel the caller names: ``flat_kernel_for(x)``
    or ``"byte"``. Raises for any other name and for a CPU tensor."""
    _check_kernel(k_copy, kernel, flat_kernel_for(x))
    return _k_copy(kernel, x)


def _k_copy(kernel: str, x: torch.Tensor) -> torch.Tensor:
    _check("x", x, torch.int8, x.dim())
    out = torch.empty_like(x)
    _launch(k_copy, kernel, "copy", x, x.data_ptr(), out.data_ptr(), x.numel())
    return out


def _staged(wrapper, mode: int, x: torch.Tensor, plain) -> torch.Tensor:
    if x.is_cpu:
        return plain(x)
    return _staged_run(wrapper, mode, probe_kernel_for(x), x)


def _staged_on(wrapper, mode: int, kernel: str, x: torch.Tensor) -> torch.Tensor:
    _check_kernel(wrapper, kernel, probe_kernel_for(x))
    return _staged_run(wrapper, mode, kernel, x)


def _staged_run(wrapper, mode: int, kernel: str, x: torch.Tensor) -> torch.Tensor:
    _check("x", x, torch.int8, 4)
    b, h, w, c = x.shape
    if c > MAX_C or (mode == 3 and c % 4):
        raise ValueError(f"C = {c}: at most {MAX_C}"
                         + (", a multiple of 4" if mode == 3 else ""))
    if b > 65535:
        raise ValueError(f"batch {b} outside 1..65535")
    if h * w * c >= 2 ** 31:
        raise ValueError("the kernels index a frame in 32 bits")
    out = torch.empty_like(x)
    _launch(wrapper, kernel, "staged", x,
            mode, x.data_ptr(), out.data_ptr(), b, h, w, c, BAND)
    return out


def k_stage(x: torch.Tensor) -> torch.Tensor:
    """Copy of an int8 (B, H, W, C) frame through a zero-filled staged tile
    with a halo of 2, interior read back."""
    return _staged(k_stage, 0, x, k_stage_plain)


def k_stage_on(kernel: str, x: torch.Tensor) -> torch.Tensor:
    """:func:`k_stage` on ``probe_kernel_for(x)`` or ``"byte"``; raises for
    any other name and for a CPU tensor. So do the other ``*_on``."""
    return _staged_on(k_stage, 0, kernel, x)


def k_dyn_read(x: torch.Tensor) -> torch.Tensor:
    """As :func:`k_stage`, read in bands at a run-time row offset, each with
    its column halo, interior columns kept."""
    return _staged(k_dyn_read, 1, x, k_dyn_read_plain)


def k_dyn_read_on(kernel: str, x: torch.Tensor) -> torch.Tensor:
    return _staged_on(k_dyn_read, 1, kernel, x)


def k_reshape(x: torch.Tensor) -> torch.Tensor:
    """As :func:`k_dyn_read`, each band addressed through a flat pixel index
    and back."""
    return _staged(k_reshape, 2, x, k_reshape_plain)


def k_reshape_on(kernel: str, x: torch.Tensor) -> torch.Tensor:
    return _staged_on(k_reshape, 2, kernel, x)


def k_concat_dot(x: torch.Tensor) -> torch.Tensor:
    """9-tap dilation-2 SAME int8 conv of (B, H, W, C), all-ones (9 * C, C)
    weights, clipped to +-127."""
    return _staged(k_concat_dot, 3, x, k_concat_dot_plain)


def k_concat_dot_on(kernel: str, x: torch.Tensor) -> torch.Tensor:
    return _staged_on(k_concat_dot, 3, kernel, x)


def full_epilogue(x, w, mult, bias) -> torch.Tensor:
    """``full_kernel``: int8 conv, dequant, LeakyReLU 0.1, requant ``* 64``,
    on im2col weights (9 * C, Cout) int8 or on the same packed once by
    ``pack_qconv_weights`` ((9, C / 4, Cout) int32, which nothing repacks).
    The kernel is ``quantized_conv3x3``'s; its launches count there."""
    if x.is_cpu:
        return full_epilogue_plain(x, w, mult, bias)
    if w.dtype != torch.int32:  # packed weights are checked by quantized_conv3x3
        check_operand("w", w, (9 * x.shape[-1], w.shape[-1]), torch.int8, x.device)
    return quantized_conv3x3(x, _hwio(w), mult, bias, inv_out=64.0)


def int8_vector_arith(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * 2 + b`` on int8 tensors of one shape, wrapping."""
    if a.is_cpu:
        return int8_vector_arith_plain(a, b)
    return _int8_vector_arith(flat_kernel_for(a, b), a, b)


def int8_vector_arith_on(kernel: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_kernel(int8_vector_arith, kernel, flat_kernel_for(a, b))
    return _int8_vector_arith(kernel, a, b)


def _int8_vector_arith(kernel: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check("a", a, torch.int8, a.dim())
    check_operand("b", b, tuple(a.shape), torch.int8, a.device)
    out = torch.empty_like(a)
    _launch(int8_vector_arith, kernel, "int8_axpb", a,
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel())
    return out


def _slabs(x: torch.Tensor) -> tuple[int, int]:
    n = x.shape[0]
    return n, x.numel() // n


def grid_scale(x: torch.Tensor) -> torch.Tensor:
    """``x * 2.0`` on float32 (n, rows, cols): a grid of n blocks."""
    if x.is_cpu:
        return grid_scale_plain(x)
    return _grid_scale(flat_kernel_for(x), x)


def grid_scale_on(kernel: str, x: torch.Tensor) -> torch.Tensor:
    _check_kernel(grid_scale, kernel, flat_kernel_for(x))
    return _grid_scale(kernel, x)


def _grid_scale(kernel: str, x: torch.Tensor) -> torch.Tensor:
    _check("x", x, torch.float32, 3)
    out = torch.empty_like(x)
    _launch(grid_scale, kernel, "grid_scale", x,
            x.data_ptr(), out.data_ptr(), *_slabs(x))
    return out


def int8_vector_in_grid(x: torch.Tensor) -> torch.Tensor:
    """``int8(((int32)x * 3 + 7) >> 2)`` on int8 (n, rows, cols): a grid of
    n blocks."""
    if x.is_cpu:
        return int8_vector_in_grid_plain(x)
    return _int8_vector_in_grid(flat_kernel_for(x), x)


def int8_vector_in_grid_on(kernel: str, x: torch.Tensor) -> torch.Tensor:
    _check_kernel(int8_vector_in_grid, kernel, flat_kernel_for(x))
    return _int8_vector_in_grid(kernel, x)


def _int8_vector_in_grid(kernel: str, x: torch.Tensor) -> torch.Tensor:
    _check("x", x, torch.int8, 3)
    out = torch.empty_like(x)
    _launch(int8_vector_in_grid, kernel, "int8_in_grid", x,
            x.data_ptr(), out.data_ptr(), *_slabs(x))
    return out


# every probe that launches a kernel of csrc/probes.cu
PROBES = (k_copy, k_stage, k_dyn_read, k_reshape, k_concat_dot,
          int8_vector_arith, grid_scale, int8_vector_in_grid)
for _fn in PROBES:
    _fn.launches = 0
    _fn.launches_by_kernel = dict.fromkeys(KERNEL_CODES, 0)
