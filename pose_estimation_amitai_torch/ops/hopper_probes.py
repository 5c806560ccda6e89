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
  weights, whatever the batch (the script's grid 1 and 4);
* :func:`int8_vector_arith` — ``a * 2 + b`` in int8, wrapping;
* :func:`grid_scale` — ``x * 2.0`` on (n, rows, cols) float32, one block
  per slab (``probe_grid``);
* :func:`int8_vector_in_grid` — ``int8(((int32)x * 3 + 7) >> 2)`` on
  (n, rows, cols) int8, one block per slab.

On a CUDA tensor each launches ``csrc/probes.cu`` (``full_epilogue``:
``csrc/qconv_stage.cu``); on a CPU tensor it runs its ``*_plain`` version.
Nothing falls back from one to the other. Every kernel equals its plain
version, every element.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .hopper_conv import check_operand
from .hopper_qconv import quantized_conv3x3, quantized_conv3x3_plain
from .int8_conv import conv_s32

MAX_C = 64  # channels of a staged tile (16 x 32 pixels + halo in 48 KB)
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
    """(9 * C, Cout) im2col weights, row = tap * C + ci -> (3, 3, C, Cout)."""
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
# kernels
# ---------------------------------------------------------------------------
def _lib() -> ctypes.CDLL:
    lib = _build.load("probes")
    if lib.pe_probe_copy.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn, args in (
            (lib.pe_probe_copy, [p, p, ll, p]),
            (lib.pe_probe_staged, [i, p, p, i, i, i, i, i, p]),
            (lib.pe_probe_int8_axpb, [p, p, p, ll, p]),
            (lib.pe_probe_grid_scale, [p, p, i, i, p]),
            (lib.pe_probe_int8_in_grid, [p, p, i, i, p]),
        ):
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, dim: int) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: on {x.device}, expected a CUDA tensor")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if x.dim() != dim or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{name}: must be contiguous, non-empty, {dim}-D")


def _launch(wrapper, symbol: str, like: torch.Tensor, args) -> torch.Tensor:
    """Run ``lib.<symbol>(*args(out), stream)`` on like's device and stream;
    count the launch on ``wrapper``."""
    out = torch.empty_like(like)
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        rc = getattr(_lib(), symbol)(*args(out), stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel: CUDA error {rc}")
    wrapper.launches += 1
    return out


def k_copy(x: torch.Tensor) -> torch.Tensor:
    """Identity copy of an int8 tensor."""
    if x.device.type == "cpu":
        return k_copy_plain(x)
    _check("x", x, torch.int8, x.dim())
    return _launch(k_copy, "pe_probe_copy", x,
                   lambda o: (x.data_ptr(), o.data_ptr(), x.numel()))


def _staged(wrapper, mode: int, x: torch.Tensor, plain) -> torch.Tensor:
    if x.device.type == "cpu":
        return plain(x)
    _check("x", x, torch.int8, 4)
    b, h, w, c = x.shape
    if c > MAX_C or (mode == 3 and c % 4):
        raise ValueError(f"C = {c}: at most {MAX_C}"
                         + (", a multiple of 4" if mode == 3 else ""))
    if b > 65535:
        raise ValueError(f"batch {b} outside 1..65535")
    return _launch(wrapper, "pe_probe_staged", x, lambda o: (
        mode, x.data_ptr(), o.data_ptr(), b, h, w, c, BAND))


def k_stage(x: torch.Tensor) -> torch.Tensor:
    """Copy of an int8 (B, H, W, C) frame through a zero-filled staged tile
    with a halo of 2, interior read back."""
    return _staged(k_stage, 0, x, k_stage_plain)


def k_dyn_read(x: torch.Tensor) -> torch.Tensor:
    """As :func:`k_stage`, read in bands at a run-time row offset, each with
    its column halo, interior columns kept."""
    return _staged(k_dyn_read, 1, x, k_dyn_read_plain)


def k_reshape(x: torch.Tensor) -> torch.Tensor:
    """As :func:`k_dyn_read`, each band addressed through a flat pixel index
    and back."""
    return _staged(k_reshape, 2, x, k_reshape_plain)


def k_concat_dot(x: torch.Tensor) -> torch.Tensor:
    """9-tap dilation-2 SAME int8 conv of (B, H, W, C), all-ones (9 * C, C)
    weights, clipped to +-127."""
    return _staged(k_concat_dot, 3, x, k_concat_dot_plain)


def full_epilogue(x, w, mult, bias) -> torch.Tensor:
    """``full_kernel``: int8 conv, dequant, LeakyReLU 0.1, requant ``* 64``,
    on im2col weights (9 * C, Cout). The kernel is ``quantized_conv3x3``'s;
    its launches count there."""
    if x.device.type == "cpu":
        return full_epilogue_plain(x, w, mult, bias)
    check_operand("w", w, (9 * x.shape[-1], w.shape[-1]), torch.int8, x.device)
    return quantized_conv3x3(x, _hwio(w), mult, bias, inv_out=64.0)


def int8_vector_arith(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * 2 + b`` on int8 tensors of one shape, wrapping."""
    if a.device.type == "cpu":
        return int8_vector_arith_plain(a, b)
    _check("a", a, torch.int8, a.dim())
    check_operand("b", b, tuple(a.shape), torch.int8, a.device)
    return _launch(int8_vector_arith, "pe_probe_int8_axpb", a, lambda o: (
        a.data_ptr(), b.data_ptr(), o.data_ptr(), a.numel()))


def _slabs(x: torch.Tensor) -> tuple[int, int]:
    n = x.shape[0]
    return n, x.numel() // n


def grid_scale(x: torch.Tensor) -> torch.Tensor:
    """``x * 2.0`` on float32 (n, rows, cols): a grid of n blocks."""
    if x.device.type == "cpu":
        return grid_scale_plain(x)
    _check("x", x, torch.float32, 3)
    return _launch(grid_scale, "pe_probe_grid_scale", x, lambda o: (
        x.data_ptr(), o.data_ptr(), *_slabs(x)))


def int8_vector_in_grid(x: torch.Tensor) -> torch.Tensor:
    """``int8(((int32)x * 3 + 7) >> 2)`` on int8 (n, rows, cols): a grid of
    n blocks."""
    if x.device.type == "cpu":
        return int8_vector_in_grid_plain(x)
    _check("x", x, torch.int8, 3)
    return _launch(int8_vector_in_grid, "pe_probe_int8_in_grid", x, lambda o: (
        x.data_ptr(), o.data_ptr(), *_slabs(x)))


# every probe that launches a kernel of csrc/probes.cu
PROBES = (k_copy, k_stage, k_dyn_read, k_reshape, k_concat_dot,
          int8_vector_arith, grid_scale, int8_vector_in_grid)
for _fn in PROBES:
    _fn.launches = 0
