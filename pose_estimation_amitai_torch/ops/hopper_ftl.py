"""The 4-camera disentanglement model's middle as one Hopper kernel.

``csrc/ftl_fusion.cu`` computes what ``ops/ftl_fusion.py``'s
``ftl_fusion_plain`` computes, for bfloat16 latents at the encoder widths
``WIDTHS`` and the latent width ``LATENT`` (300, so 400 canonical channels):
the four 1x1s on the bf16 tensor cores (``wgmma``, float32 sums), both FTLs
and the BatchNorms in float32 on the CUDA cores, every intermediate in
registers and shared memory, rounded where the plain version rounds. One
launch a call: ``ftl_fusion_kernel`` reads the latent once, again for the
skip, and writes the output. It reads the four weight matrices as
:func:`packed_weights` lays them out, the kernel's shared-memory stages
(about 2.1 MB), packed by ``pack_ftl_weights`` on the first call for a set of
weights and kept while those tensors live unchanged.

:func:`ftl_fusion_kernel` takes CUDA tensors only and raises on anything the
kernel does not take; ``ops/ftl_fusion.py`` picks it by
:func:`ftl_kernel_takes`. Each run adds one to
``ftl_fusion_kernel.launches``, each packing one to
``packed_weights.launches``.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from . import _build
from .hopper_conv import check_operand

WIDTHS = (64, 128, 256)  # encoder widths C: the instances pe_ftl_fusion dispatches to
LATENT = 300  # latent_3d_channels: 100 groups of 3, 400 canonical channels
VIEWS = 4


def ftl_kernel_takes(dtype: torch.dtype, width: int, latent: int) -> bool:
    """Whether the kernel takes latents of this dtype, encoder width and
    latent width: bfloat16, ``WIDTHS``, ``LATENT``."""
    return dtype == torch.bfloat16 and width in WIDTHS and latent == LATENT


def _lib() -> ctypes.CDLL:
    lib = _build.load("ftl_fusion")
    fn = lib.pe_ftl_fusion
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [ctypes.c_float, p, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.pe_ftl_pack.argtypes = [p] * 5 + [i, p]
        lib.pe_ftl_pack.restype = ctypes.c_int
        lib.pe_ftl_packed_bytes.argtypes = [i]
        lib.pe_ftl_packed_bytes.restype = ctypes.c_longlong
    return lib


_packed: tuple | None = None  # (weak references to the weights, their versions, the stages)


def packed_weights(w_r1: torch.Tensor, w_f1: torch.Tensor, w_f2: torch.Tensor,
                   w_r2: torch.Tensor) -> torch.Tensor:
    """The four 1x1s (checked by the caller) as the kernel's stages, a uint8
    buffer on their device: packed on the current stream the first time
    these tensors come, and again only when another set comes or one of
    them has changed in place (its version counter). Inference tensors keep
    no version counter, so they are packed on every call."""
    global _packed
    ws = (w_r1, w_f1, w_f2, w_r2)
    versions = None if any(w.is_inference() for w in ws) else tuple(w._version for w in ws)
    if versions is not None and _packed is not None:
        refs, seen, stages = _packed
        if seen == versions and all(r() is w for r, w in zip(refs, ws)):
            return stages
    lib, dev = _lib(), w_r1.device
    stages = torch.empty(lib.pe_ftl_packed_bytes(w_r1.shape[0]), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.pe_ftl_pack(*(t.data_ptr() for t in (*ws, stages)), w_r1.shape[0],
                             torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pack_ftl_weights: CUDA error {rc}")
    packed_weights.launches += 1
    if versions is not None:
        _packed = (tuple(weakref.ref(w) for w in ws), versions, stages)
    return stages


packed_weights.launches = 0


def ftl_fusion_kernel(
    latent: torch.Tensor, P: torch.Tensor, P_inv: torch.Tensor,
    w_r1: torch.Tensor, b_r1: torch.Tensor, w_f1: torch.Tensor, b_f1: torch.Tensor,
    w_f2: torch.Tensor, b_f2: torch.Tensor, w_r2: torch.Tensor, b_r2: torch.Tensor,
    bn1: torch.Tensor, bn2: torch.Tensor, bn3: torch.Tensor, eps: float,
) -> torch.Tensor:
    """(4B, h, w, C) bf16 view-rows of encoder outputs -> the decoder's (4B,
    h, w, C) input, on ``csrc/ftl_fusion.cu``. Operands as ``ftl_fusion``
    takes them, contiguous on the latent's CUDA device: the 1x1s (Cin, Cout)
    and their biases bf16, the cameras and BatchNorm stacks float32."""
    if not latent.is_cuda:
        raise ValueError(f"latent on {latent.device}, expected a CUDA tensor")
    if latent.dim() != 4 or latent.shape[0] % VIEWS or latent.shape[0] == 0:
        raise ValueError(f"latent {tuple(latent.shape)}: expected (4B, h, w, C) view-rows")
    n4, h, w, c = latent.shape
    if not ftl_kernel_takes(latent.dtype, c, w_r1.shape[-1]):
        raise ValueError(f"the kernel takes bfloat16 latents of width {WIDTHS} into "
                         f"{LATENT}, got {latent.dtype} {c} -> {w_r1.shape[-1]}")
    b, dev, bf16, f32 = n4 // VIEWS, latent.device, torch.bfloat16, torch.float32
    canon = LATENT // 3 * 4
    check_operand("latent", latent, (n4, h, w, c), bf16, dev)
    for name, t, shape, dt in (
            ("P", P, (b, VIEWS, 3, 4), f32), ("P_inv", P_inv, (b, VIEWS, 4, 3), f32),
            ("w_r1", w_r1, (c, LATENT), bf16), ("b_r1", b_r1, (LATENT,), bf16),
            ("w_f1", w_f1, (VIEWS * canon, canon), bf16), ("b_f1", b_f1, (canon,), bf16),
            ("w_f2", w_f2, (canon, canon), bf16), ("b_f2", b_f2, (canon,), bf16),
            ("w_r2", w_r2, (LATENT, c), bf16), ("b_r2", b_r2, (c,), bf16),
            ("bn1", bn1, (4, canon), f32), ("bn2", bn2, (4, canon), f32),
            ("bn3", bn3, (4, LATENT), f32)):
        check_operand(name, t, shape, dt, dev)
    stages = packed_weights(w_r1, w_f1, w_f2, w_r2)
    out = torch.empty_like(latent)
    with torch.cuda.device(dev):
        rc = _lib().pe_ftl_fusion(
            *(t.data_ptr() for t in (latent, P, P_inv, stages, b_r1, b_f1, b_f2, b_r2,
                                     bn1, bn2, bn3)),
            eps, out.data_ptr(), b, h * w, c, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ftl_fusion_kernel: CUDA error {rc}")
    ftl_fusion_kernel.launches += 1
    return out


ftl_fusion_kernel.launches = 0
