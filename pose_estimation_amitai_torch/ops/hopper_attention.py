"""Fused softmax attention: Hopper kernel and plain version.

Counterpart of ``scripts/exp_fused_attention.py`` (``fused_attention``, its
Pallas body ``_attention_kernel``, and ``reference_attention``). Per fused
batch-head ``g``

    logits = (q k^T) * D**-0.5     accumulated and scaled in float32
    p      = softmax(logits)       float32, divided before the cast,
                                   then rounded to q's dtype
    out    = p v                   accumulated in float32, stored in q's dtype

Public contract, as the script's: q, k, v ``(G, N, D)`` with ``G = batch *
heads`` -> ``(G, N, D)``. The same function also takes 4-D ``(B, H, N, D)``
views: any strides for b, h and n, last dimension contiguous, so the ViT's
``Attention`` passes slices of its one ``(B, N, 3, H, D)`` qkv tensor and an
``out`` view of its ``(B, N, H, D)`` result and no transposing copy is made.

On a CUDA tensor :func:`fused_attention` launches ``csrc/attention.cu``; on
a CPU tensor it runs :func:`fused_attention_plain`. Nothing falls back from
one to the other. float32 or bfloat16; D a multiple of 8; N at most
:data:`MAX_N` (a query tile's logits against all keys live in shared memory).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .hopper_conv import DTYPE_CODES

MAX_N = 1056  # 48 x (N + 4) f32 logits + two 48 x 68 f32 chunks <= 227 KB


def fused_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_attention`, step by step, any
    device: both products in float32 on the inputs' exact values, softmax in
    float32, probabilities rounded to q's dtype before the second product.
    Returns a contiguous tensor of q's shape and dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("...nd,...md->...nm", q.float(), k.float()) * scale
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("...nm,...md->...nd", p.float(), v.float())
    return out.to(q.dtype).contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load("attention")
    fn = lib.pe_fused_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 4 + [i] * 4 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _check_view(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """Raise unless ``t`` is what the kernel reads through a bare pointer
    and three strides: like's shape, dtype and device, last dimension
    contiguous, base and strides 16-byte aligned."""
    if t.shape != like.shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(like.shape)}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {like.dtype}")
    if t.device != like.device:
        raise ValueError(f"{name}: on {t.device}, expected {like.device}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dimension must be contiguous")
    per16 = 16 // t.element_size()
    if t.data_ptr() % 16 or any(
            s % per16 for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1):
        raise ValueError(f"{name}: base and strides must be 16-byte aligned")


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """``softmax(q k^T * D**-0.5) v`` per fused batch-head.

    Args:
      q, k, v: ``(G, N, D)`` or ``(B, H, N, D)``, float32 or bfloat16, one
        shape, dtype and device; views with any b/h/n strides.
      out: optional tensor (or view) of the same shape to write into.

    Returns ``out`` (a new contiguous tensor if none was given). CUDA
    tensors run the ``csrc/attention.cu`` kernel (one launch; logits and
    probabilities stay in shared memory); CPU tensors run the plain version.
    Each kernel run adds one to ``fused_attention.launches``.
    """
    if q.dim() not in (3, 4):
        raise ValueError(f"q must be (G, N, D) or (B, H, N, D), got {tuple(q.shape)}")
    if q.device.type == "cpu":
        res = fused_attention_plain(q, k, v)
        if out is None:
            return res
        out.copy_(res)
        return out
    if not q.is_cuda:
        raise ValueError(f"kernel input on {q.device}, expected a CUDA tensor")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    n, d = q.shape[-2:]
    if d % 8 or d < 8:
        raise ValueError(f"D = {d} must be a positive multiple of 8")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"N = {n} outside 1..{MAX_N}")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_view(name, t, q)
    if q.numel() == 0:
        return out
    views = [t if t.dim() == 4 else t.unsqueeze(1) for t in (q, k, v, out)]
    b, h = views[0].shape[:2]
    strides = (ctypes.c_longlong * 12)(
        *[s for t in views for s in t.stride()[:3]])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().pe_fused_attention(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, h, n, d, strides, d ** -0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_attention kernel: CUDA error {rc}")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
