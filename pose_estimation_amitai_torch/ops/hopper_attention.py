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
:data:`MAX_N`.

The source holds two kernels, and :func:`attention_kernel_for` chooses
between them from dtype and shape alone: ``"mma"``, both products on the bf16
tensor cores with q, k, v of one g whole in shared memory (bfloat16, N up to
:data:`MMA_MAX_N`, D a multiple of 16, within :data:`SMEM_MAX`: every shape
the ViTs serve); ``"fma"``, f32 arithmetic on the CUDA cores with a query
tile's logits against all keys in shared memory (float32, where TF32 would
break the 1e-4 limit, and every other bfloat16 shape).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .hopper_conv import DTYPE_CODES, SMEM_MAX

MAX_N = 1056  # "fma": 48 x (N + 4) f32 logits + two 48 x 68 f32 chunks <= 227 KB
MMA_MAX_N = 144  # "mma": 9 warps x 16 query rows (+ 1 that copies); 72 f32 logit registers a thread
MMA_PAD = 8  # bf16 of padding a staged row: ldmatrix rows fall in distinct banks
MMA_BAR_BYTES = 32  # four mbarriers behind the three buffers
KERNEL_CODES = {"fma": 0, "mma": 1}


def attention_mma_smem_bytes(n: int, d: int) -> int:
    """Shared memory the ``"mma"`` kernel asks for: q, k and v of one g in
    bf16, N rounded up to 16-row tiles, rows padded by :data:`MMA_PAD`, and
    the copies' barriers. The rule needs the figure where nothing is built;
    the kernel's own is :func:`attention_mma_smem_bytes_built`, and the
    card's tests hold the two equal."""
    return 3 * (-(-n // 16) * 16) * (d + MMA_PAD) * 2 + MMA_BAR_BYTES


def attention_kernel_for(dtype: torch.dtype, n: int, d: int) -> str:
    """Which kernel of ``csrc/attention.cu`` a CUDA call of this dtype and
    shape launches: ``"mma"`` or ``"fma"``. A rule on dtype and shape only;
    shapes neither kernel takes are refused by :func:`fused_attention`."""
    if (dtype == torch.bfloat16 and 1 <= n <= MMA_MAX_N and d >= 16
            and d % 16 == 0 and attention_mma_smem_bytes(n, d) <= SMEM_MAX):
        return "mma"
    return "fma"


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
        fn.argtypes = [i, i] + [p] * 4 + [i] * 4 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.pe_attention_mma_smem_bytes.argtypes = [i, i]
        lib.pe_attention_mma_smem_bytes.restype = ctypes.c_longlong
    return lib


def attention_mma_smem_bytes_built(n: int, d: int) -> int:
    """The same figure from the built library: what the launch asks for."""
    return _lib().pe_attention_mma_smem_bytes(n, d)


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
    tensors run one kernel of ``csrc/attention.cu`` (one launch; logits and
    probabilities never reach device memory), the one
    :func:`attention_kernel_for` names; CPU tensors run the plain version.
    Each kernel run adds one to ``fused_attention.launches`` and to
    ``fused_attention.launches_by_kernel[name]``.
    """
    if q.dim() not in (3, 4):
        raise ValueError(f"q must be (G, N, D) or (B, H, N, D), got {tuple(q.shape)}")
    if q.device.type == "cpu":
        res = fused_attention_plain(q, k, v)
        if out is None:
            return res
        out.copy_(res)
        return out
    kernel = attention_kernel_for(q.dtype, *q.shape[-2:])
    return fused_attention_on(kernel, q, k, v, out)


def fused_attention_on(
    kernel: str,
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`fused_attention` on CUDA tensors with the kernel named by the
    caller: the one :func:`attention_kernel_for` names, or ``"fma"``, which
    takes every shape (to time one kernel against the other on the same
    tensors). Raises for any other choice."""
    if q.dim() not in (3, 4):
        raise ValueError(f"q must be (G, N, D) or (B, H, N, D), got {tuple(q.shape)}")
    if not q.is_cuda:
        raise ValueError(f"kernel input on {q.device}, expected a CUDA tensor")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    n, d = q.shape[-2:]
    if d % 8 or d < 8:
        raise ValueError(f"D = {d} must be a positive multiple of 8")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"N = {n} outside 1..{MAX_N}")
    if kernel not in ("fma", attention_kernel_for(q.dtype, n, d)):
        raise ValueError(f"kernel {kernel!r} does not take {q.dtype} N = {n}, D = {d}")
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
            DTYPE_CODES[q.dtype], KERNEL_CODES[kernel],
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, h, n, d, strides, d ** -0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_attention {kernel} kernel: CUDA error {rc}")
    fused_attention.launches += 1
    fused_attention.launches_by_kernel[kernel] += 1
    return out


fused_attention.launches = 0
fused_attention.launches_by_kernel = {"fma": 0, "mma": 0}
