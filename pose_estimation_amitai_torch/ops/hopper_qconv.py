"""Fused int8 encoder stage and the single int8 conv: Hopper kernels and
plain versions.

Counterpart of ``pose_estimation_amitai_tpu/ops/pallas_qconv.py``
(:func:`fused_quantized_stage`) and of the im2col int8 conv of
``scripts/exp_im2col_pallas.py`` (:func:`quantized_conv3x3`). One int8 stage
of the flagship encoder, on int8 activations and weights with per-channel
dequant multipliers ``m`` (s_x * s_w) and float32 biases:

    y1 = bf16(LReLU(f32(conv(x))  * m1 + b1))          q1 = quant(y1, inv_s2)
    y2 = bf16(LReLU(f32(conv(q1)) * m2 + b2)) + y1     q2 = quant(y2, inv_s3)
    y3 = bf16(LReLU(f32(conv(q2)) * m3 + b3)) + y2     [pool: LReLU in f32]
    out = quant(y3, inv_out)

    quant(v, inv) = int8(clip(rint(f32(bf16(v) * bf16(inv))), -127, 127))

with 3x3 dilated SAME convs accumulated in int32 (exact), bf16 skip adds and
round-half-to-even. The output is (B, H, W, Cout) int8 and unpooled: with
``pool`` the stage applies the post-pool LeakyReLU before the quant and the
caller max-pools the int8 values, which gives the same result because
``quant(LReLU(.))`` is monotone.

The single conv is ``int8(clip(rint(LReLU(f32(conv(x)) * mult + bias) *
inv_out), -127, 127))`` with a float32 requant.

On a CUDA tensor each wrapper launches ``csrc/qconv_stage.cu``; on a CPU
tensor it runs its plain version. Nothing falls back from one to the other.
The kernels multiply and add with separate roundings (no FMA contraction), so
they equal their plain versions bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .hopper_conv import MAX_DILATION, check_operand, lrelu
from .int8_conv import conv_s32


def bf16_round(v: float) -> float:
    """``v`` rounded to the nearest bfloat16, as a Python float."""
    return float(torch.tensor(v, dtype=torch.float32).to(torch.bfloat16))


def quant_bf16(v: torch.Tensor, inv: float) -> torch.Tensor:
    """``int8(clip(rint(bf16(v) * bf16(inv)), -127, 127))``: the requant of
    the int8 serving path, product rounded to bf16, ties to even."""
    scale = torch.tensor(inv, dtype=torch.float32, device=v.device).to(torch.bfloat16)
    p = v.to(torch.bfloat16) * scale
    return p.float().round().clamp(-127, 127).to(torch.int8)


def dequant(acc: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``f32(acc) * mult + bias`` per output channel (NHWC), two roundings."""
    return acc.float() * mult + bias


def fused_quantized_stage_plain(
    x_int8: torch.Tensor,
    w1, m1, b1, w2, m2, b2, w3, m3, b3,
    inv_s2: float, inv_s3: float, inv_out: float,
    *,
    dilation: int = 2,
    alpha: float = 0.1,
    pool: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_quantized_stage`: the same
    arithmetic through the exact library conv, any device."""
    bf = torch.bfloat16
    y1 = lrelu(dequant(conv_s32(x_int8, w1, dilation), m1, b1), alpha).to(bf)
    q1 = quant_bf16(y1, inv_s2)
    y2 = lrelu(dequant(conv_s32(q1, w2, dilation), m2, b2), alpha).to(bf) + y1
    q2 = quant_bf16(y2, inv_s3)
    y3 = lrelu(dequant(conv_s32(q2, w3, dilation), m3, b3), alpha).to(bf) + y2
    if pool:
        y3 = lrelu(y3.float(), alpha)
    return quant_bf16(y3, inv_out).contiguous()


def quantized_conv3x3_plain(
    x_int8: torch.Tensor, w_int8: torch.Tensor, mult: torch.Tensor,
    bias: torch.Tensor, *, dilation: int = 2, alpha: float = 0.1,
    inv_out: float = 64.0,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantized_conv3x3`, any device."""
    y = lrelu(dequant(conv_s32(x_int8, w_int8, dilation), mult, bias), alpha)
    return (y * inv_out).round().clamp(-127, 127).to(torch.int8).contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load("qconv_stage")
    if lib.pe_fused_quantized_stage.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = lib.pe_fused_quantized_stage
        fn.argtypes = [p] * 16 + [i] * 6 + [f] * 4 + [i, p]
        fn.restype = ctypes.c_int
        fn = lib.pe_quantized_conv3x3
        fn.argtypes = [p] * 6 + [i] * 6 + [f, f, p]
        fn.restype = ctypes.c_int
    return lib


def _check_input(x: torch.Tensor) -> None:
    """Raise unless ``x`` is a contiguous (B, H, W, C) int8 CUDA tensor whose
    batch fits the kernels' grid (<= 65535)."""
    if not x.is_cuda:
        raise ValueError(f"kernel input on {x.device}, expected a CUDA tensor")
    if x.dtype != torch.int8:
        raise TypeError(f"kernel takes int8 activations, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("kernel input must be a contiguous (B, H, W, C)")
    if not 1 <= x.shape[0] <= 65535:
        raise ValueError(f"batch {x.shape[0]} outside 1..65535")


def _check_layer(k: str, w, m, b, cin: int, cout: int, dev) -> None:
    check_operand(f"w{k}", w, (3, 3, cin, cout), torch.int8, dev)
    check_operand(f"m{k}", m, (cout,), torch.float32, dev)
    check_operand(f"b{k}", b, (cout,), torch.float32, dev)


def _packed_words(cin: int, cout: int) -> int:
    """int32 words of one layer's packed weights: 9 taps x ceil(cin / 4)
    four-channel words x cout."""
    return 9 * -(-cin // 4) * cout


def fused_quantized_stage(
    x_int8: torch.Tensor,
    w1, m1, b1, w2, m2, b2, w3, m3, b3,
    inv_s2: float, inv_s3: float, inv_out: float,
    *,
    dilation: int = 2,
    alpha: float = 0.1,
    pool: bool = True,
) -> torch.Tensor:
    """Fused int8 encoder stage.

    Args:
      x_int8: (B, H, W, Cin) int8, quantized at conv1's input scale;
      wK: (3, 3, Cin/Cout, Cout) int8; mK: (Cout,) float32 dequant
      multipliers (s_x * s_w per channel); bK: (Cout,) float32 biases;
      inv_s2/inv_s3: 1/s_x of conv2/conv3; inv_out: 1/s_x of the next layer
      (the stage output is int8 at that scale).

    Returns (B, H, W, Cout) int8. With ``pool`` the extra LeakyReLU runs
    before the quant and the caller 2x2 max-pools the int8 output. CUDA
    tensors run ``csrc/qconv_stage.cu`` (three conv launches, q1/y1/q2/y2
    and the packed weights in a workspace allocated here); CPU tensors run
    the plain version. Each kernel run adds one to
    ``fused_quantized_stage.launches``.
    """
    if x_int8.device.type == "cpu":
        return fused_quantized_stage_plain(
            x_int8, w1, m1, b1, w2, m2, b2, w3, m3, b3, inv_s2, inv_s3,
            inv_out, dilation=dilation, alpha=alpha, pool=pool,
        )
    _check_input(x_int8)
    b, h, w, cin = x_int8.shape
    cout = w1.shape[-1]
    dev = x_int8.device
    _check_layer("1", w1, m1, b1, cin, cout, dev)
    _check_layer("2", w2, m2, b2, cout, cout, dev)
    _check_layer("3", w3, m3, b3, cout, cout, dev)
    if not 1 <= dilation <= MAX_DILATION:
        raise ValueError(f"dilation {dilation} outside 1..{MAX_DILATION}")
    shape = (b, h, w, cout)
    q1, q2, out = (torch.empty(shape, dtype=torch.int8, device=dev) for _ in range(3))
    y1, y2 = (torch.empty(shape, dtype=torch.bfloat16, device=dev) for _ in range(2))
    packed = torch.empty(
        _packed_words(cin, cout) + 2 * _packed_words(cout, cout),
        dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().pe_fused_quantized_stage(
            x_int8.data_ptr(), w1.data_ptr(), m1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), m2.data_ptr(), b2.data_ptr(),
            w3.data_ptr(), m3.data_ptr(), b3.data_ptr(),
            packed.data_ptr(), q1.data_ptr(), y1.data_ptr(), q2.data_ptr(),
            y2.data_ptr(), out.data_ptr(),
            b, h, w, cin, cout, dilation,
            alpha, bf16_round(inv_s2), bf16_round(inv_s3), bf16_round(inv_out),
            int(pool), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_quantized_stage kernel: CUDA error {rc}")
    fused_quantized_stage.launches += 1
    return out


fused_quantized_stage.launches = 0


def quantized_conv3x3(
    x_int8: torch.Tensor, w_int8: torch.Tensor, mult: torch.Tensor,
    bias: torch.Tensor, *, dilation: int = 2, alpha: float = 0.1,
    inv_out: float = 64.0,
) -> torch.Tensor:
    """One int8 3x3 dilated SAME conv with its dequant, LeakyReLU and
    float32 requant: (B, H, W, Cin) int8 -> (B, H, W, Cout) int8.

    ``w_int8`` (3, 3, Cin, Cout) int8; ``mult``, ``bias`` (Cout,) float32.
    CUDA tensors run ``csrc/qconv_stage.cu`` (one conv launch, the 9 taps
    folded into the contraction loop); CPU tensors run the plain version.
    Each kernel run adds one to ``quantized_conv3x3.launches``.
    """
    if x_int8.device.type == "cpu":
        return quantized_conv3x3_plain(
            x_int8, w_int8, mult, bias, dilation=dilation, alpha=alpha,
            inv_out=inv_out,
        )
    _check_input(x_int8)
    b, h, w, cin = x_int8.shape
    cout = w_int8.shape[-1]
    dev = x_int8.device
    _check_layer("", w_int8, mult, bias, cin, cout, dev)
    if not 1 <= dilation <= MAX_DILATION:
        raise ValueError(f"dilation {dilation} outside 1..{MAX_DILATION}")
    out = torch.empty((b, h, w, cout), dtype=torch.int8, device=dev)
    packed = torch.empty(_packed_words(cin, cout), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().pe_quantized_conv3x3(
            x_int8.data_ptr(), w_int8.data_ptr(), mult.data_ptr(),
            bias.data_ptr(), packed.data_ptr(), out.data_ptr(),
            b, h, w, cin, cout, dilation, alpha, inv_out, stream,
        )
    if rc != 0:
        raise RuntimeError(f"quantized_conv3x3 kernel: CUDA error {rc}")
    quantized_conv3x3.launches += 1
    return out


quantized_conv3x3.launches = 0
