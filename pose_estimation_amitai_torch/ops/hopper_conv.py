"""Fused torch-flavour encoder stages: Hopper kernel and plain version.

Counterpart of ``pose_estimation_amitai_tpu/ops/pallas_conv.py``. One stage
of the flagship encoder (reference: pytorch/CNNs.py:73-88)

    x1 = LReLU(conv(x)  + b1)
    x2 = LReLU(conv(x1) + b2) + x1
    x3 = LReLU(conv(x2) + b3) + x2     [-> 2x2 max-pool -> LReLU]

with 3x3 dilated SAME convs, f32 accumulation, and x1/x2 rounded to x's
dtype as the TPU kernel stores them (its ``a1_ref``/``a2_ref`` scratch).
On a CUDA tensor :func:`fused_encoder_stage` launches the hand-written kernel
of ``csrc/encoder_stage.cu``; on a CPU tensor it runs
:func:`fused_encoder_stage_plain`. Nothing falls back from one to the other.

Tensors keep the JAX contracts: x NHWC (B, H, W, Cin), weights HWIO
(3, 3, Cin, Cout) in x's dtype, biases (Cout,) float32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DILATION = 8  # the kernel's shared-memory patch is sized for <= 8


def lrelu(v: torch.Tensor, alpha: float) -> torch.Tensor:
    """``where(v >= 0, v, v * alpha)``, the TPU kernels' form (NaN stays)."""
    return torch.where(v >= 0, v, v * alpha)


def _conv_same(x: torch.Tensor, w_hwio: torch.Tensor, dilation: int):
    """f32 SAME 3x3 conv of NCHW ``x`` with an HWIO kernel."""
    w = w_hwio.float().permute(3, 2, 0, 1)
    return F.conv2d(x, w, padding=dilation, dilation=dilation)


def bias_nchw(b: torch.Tensor) -> torch.Tensor:
    """(C,) bias as a float32 (1, C, 1, 1) NCHW broadcast."""
    return b.float()[None, :, None, None]


def fused_encoder_stage_plain(
    x: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    w3: torch.Tensor, b3: torch.Tensor,
    *,
    dilation: int = 2,
    alpha: float = 0.1,
    pool: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_encoder_stage`: the same
    arithmetic (f32 compute, x1/x2 rounded to x's dtype), any device."""
    dt = x.dtype
    h = x.permute(0, 3, 1, 2).float()
    x1 = lrelu(_conv_same(h, w1, dilation) + bias_nchw(b1), alpha).to(dt).float()
    x2 = (lrelu(_conv_same(x1, w2, dilation) + bias_nchw(b2), alpha) + x1)
    x2 = x2.to(dt).float()
    y = lrelu(_conv_same(x2, w3, dilation) + bias_nchw(b3), alpha) + x2
    if pool:
        # flax max_pool(2, 2, SAME) == ceil_mode for odd sizes
        y = lrelu(F.max_pool2d(y, 2, 2, ceil_mode=True), alpha)
    return y.to(dt).permute(0, 2, 3, 1).contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load("encoder_stage")
    fn = lib.pe_fused_encoder_stage
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 10 + [i] * 6 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib


def check_operand(
    name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
    device: torch.device,
) -> None:
    """Raise unless ``t`` has this shape, dtype and device and is
    contiguous — what a kernel takes through a bare pointer."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_input(x: torch.Tensor) -> None:
    """Raise unless ``x`` is a 4-D contiguous float32/bfloat16 CUDA tensor
    whose batch fits the kernels' grid (<= 65535)."""
    if not x.is_cuda:
        raise ValueError(f"kernel input on {x.device}, expected a CUDA tensor")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("kernel input must be a contiguous (B, H, W, C)")
    if not 1 <= x.shape[0] <= 65535:
        raise ValueError(f"batch {x.shape[0]} outside 1..65535")


def fused_encoder_stage(
    x: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    w3: torch.Tensor, b3: torch.Tensor,
    *,
    dilation: int = 2,
    alpha: float = 0.1,
    pool: bool = True,
) -> torch.Tensor:
    """Fused (conv -> conv(+skip) -> conv(+skip) [-> maxpool]) stage.

    Returns (B, H/2, W/2, Cout) if ``pool`` else (B, H, W, Cout), in x's
    dtype. CUDA tensors run the ``csrc/encoder_stage.cu`` kernel (three
    launches, x1/x2 in a workspace allocated here); CPU tensors run the
    plain version. Each kernel run adds one to
    ``fused_encoder_stage.launches``.
    """
    if x.device.type == "cpu":
        return fused_encoder_stage_plain(
            x, w1, b1, w2, b2, w3, b3,
            dilation=dilation, alpha=alpha, pool=pool,
        )
    check_input(x)
    b, h, w, cin = x.shape
    cout = w1.shape[-1]
    dt, dev = x.dtype, x.device
    check_operand("w1", w1, (3, 3, cin, cout), dt, dev)
    check_operand("w2", w2, (3, 3, cout, cout), dt, dev)
    check_operand("w3", w3, (3, 3, cout, cout), dt, dev)
    for name, bias in (("b1", b1), ("b2", b2), ("b3", b3)):
        check_operand(name, bias, (cout,), torch.float32, dev)
    if not 1 <= dilation <= MAX_DILATION:
        raise ValueError(f"dilation {dilation} outside 1..{MAX_DILATION}")
    if pool and (h % 2 or w % 2):
        raise ValueError(f"pooling needs even H, W, got {h}x{w}")
    out_shape = (b, h // 2, w // 2, cout) if pool else (b, h, w, cout)
    ws1 = torch.empty((b, h, w, cout), dtype=dt, device=dev)
    ws2 = torch.empty((b, h, w, cout), dtype=dt, device=dev)
    out = torch.empty(out_shape, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().pe_fused_encoder_stage(
            DTYPE_CODES[dt], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
            ws1.data_ptr(), ws2.data_ptr(), out.data_ptr(),
            b, h, w, cin, cout, dilation, alpha, int(pool), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_encoder_stage kernel: CUDA error {rc}")
    fused_encoder_stage.launches += 1
    return out


fused_encoder_stage.launches = 0


def encoder_forward_fused(
    x: torch.Tensor,
    stage_params: list[dict],
    *,
    dilation: int = 2,
    alpha: float = 0.1,
) -> torch.Tensor:
    """Full torch-flavour encoder: 3 fused stages (pool after 1 and 2).

    ``stage_params[k]`` holds w1/b1/w2/b2/w3/b3 HWIO tensors for stage k.
    Inference only (dropout is identity at eval).
    """
    for k, p in enumerate(stage_params):
        x = fused_encoder_stage(
            x, p["w1"], p["b1"], p["w2"], p["b2"], p["w3"], p["b3"],
            dilation=dilation, alpha=alpha, pool=k < 2,
        )
    return x
