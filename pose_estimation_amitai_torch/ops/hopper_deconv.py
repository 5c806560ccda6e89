"""Fused torch-flavour transposed-conv decoder: Hopper kernel and plain
version.

Counterpart of ``pose_estimation_amitai_tpu/ops/pallas_deconv.py``. The
flagship decoder (reference: pytorch/CNNs.py:92-157)

    t1 = LReLU(up2(latent, W1) + b1)            cin -> mid
    t2 = LReLU(s1(t1, W2) + b2) + t1
    t3 = LReLU(s1(t2, W3) + b3) + t2
    y  = LReLU(up2(t3, W4) + b4)                mid -> K

on flax ConvTranspose HWIO kernels: ``s1`` is flax's stride-1
ConvTranspose(SAME), an unflipped SAME correlation; ``up2`` is the
torch-flavour stride-2 layer, y[2j] = x[j] W[1], y[2j+1] = x[j] W[0] +
x[j+1] W[2] per axis, which is ``ConvTranspose2d(k3, s2, padding=1,
output_padding=1)`` with the kernel flipped in space. Intermediates are
rounded to the latent's dtype, as the TPU kernel's scratch holds them.

On a CUDA tensor :func:`fused_decoder` launches ``csrc/decoder.cu``; on a
CPU tensor it runs :func:`fused_decoder_plain`. Any cin, mid and K.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .hopper_conv import (
    CONV_KERNEL_CODES, DTYPE_CODES, bias_nchw, check_input, check_operand,
    conv_kernel_for, lrelu,
)


def _s1(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """flax stride-1 ConvTranspose(SAME), k3: unflipped SAME correlation."""
    return F.conv2d(x, w_hwio.float().permute(3, 2, 0, 1), padding=1)


def _up2(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """torch-flavour stride-2 ConvTranspose on a flax HWIO kernel."""
    w = torch.flip(w_hwio.float(), (0, 1)).permute(2, 3, 0, 1)  # (I, O, kh, kw)
    return F.conv_transpose2d(x, w, stride=2, padding=1, output_padding=1)


def fused_decoder_plain(
    latent: torch.Tensor,
    w1, b1, w2, b2, w3, b3, w4, b4,
    *,
    alpha: float = 0.1,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_decoder` (f32 compute,
    intermediates rounded to the latent's dtype), any device."""
    dt = latent.dtype
    h = latent.permute(0, 3, 1, 2).float()
    t1 = lrelu(_up2(h, w1) + bias_nchw(b1), alpha).to(dt).float()
    t2 = (lrelu(_s1(t1, w2) + bias_nchw(b2), alpha) + t1).to(dt).float()
    t3 = (lrelu(_s1(t2, w3) + bias_nchw(b3), alpha) + t2).to(dt).float()
    y = lrelu(_up2(t3, w4) + bias_nchw(b4), alpha)
    return y.to(dt).permute(0, 2, 3, 1).contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load("decoder")
    fn = lib.pe_fused_decoder
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 12 + [i] * 6 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib


def fused_decoder(
    latent: torch.Tensor,
    w1, b1, w2, b2, w3, b3, w4, b4,
    *,
    alpha: float = 0.1,
) -> torch.Tensor:
    """Fused torch-flavour DecoderUp: (B, R, W, cin) -> (B, 4R, 4W, K) in
    the latent's dtype.

    Weights are flax ConvTranspose HWIO kernels in the latent's dtype,
    biases float32. CUDA tensors run the ``csrc/decoder.cu`` kernels (four
    launches writing the interleaved output directly, intermediates in a
    workspace the wrapper allocates); CPU tensors run the plain version. The
    two stride-1 convs run the kernel ``hopper_conv.conv_kernel_for`` names
    for (mid -> mid, dilation 1): the tensor-core one in bfloat16 when mid is
    a multiple of 16. Each kernel run adds one to ``fused_decoder.launches``
    and its two convs to ``fused_decoder.convs_by_kernel``.
    """
    if latent.device.type == "cpu":
        return fused_decoder_plain(
            latent, w1, b1, w2, b2, w3, b3, w4, b4, alpha=alpha
        )
    mid = w1.shape[-1]
    conv_kernel = conv_kernel_for(latent.dtype, mid, mid, 1)
    return fused_decoder_on(conv_kernel, latent, w1, b1, w2, b2, w3, b3, w4, b4,
                            alpha=alpha)


def fused_decoder_on(
    conv_kernel: str,
    latent: torch.Tensor,
    w1, b1, w2, b2, w3, b3, w4, b4,
    *,
    alpha: float = 0.1,
) -> torch.Tensor:
    """:func:`fused_decoder` on CUDA tensors with the kernel of the two
    stride-1 convs named by the caller: the one ``conv_kernel_for`` names, or
    ``"fma"``, which takes every shape (to time one kernel against the other
    on the same tensors). Raises for any other choice."""
    check_input(latent)
    b, r, wd, cin = latent.shape
    mid = w1.shape[-1]
    k = w4.shape[-1]
    dt, dev = latent.dtype, latent.device
    check_operand("w1", w1, (3, 3, cin, mid), dt, dev)
    check_operand("w2", w2, (3, 3, mid, mid), dt, dev)
    check_operand("w3", w3, (3, 3, mid, mid), dt, dev)
    check_operand("w4", w4, (3, 3, mid, k), dt, dev)
    for name, bias, n in (("b1", b1, mid), ("b2", b2, mid), ("b3", b3, mid),
                          ("b4", b4, k)):
        check_operand(name, bias, (n,), torch.float32, dev)
    if 4 * r * wd >= 2 ** 31:
        raise ValueError(f"{2 * r}x{2 * wd} pixels a map: the kernels index them in 32 bits")
    if conv_kernel not in ("fma", conv_kernel_for(dt, mid, mid, 1)):
        raise ValueError(f"kernel {conv_kernel!r} does not take {dt} {mid} -> {mid} channels")
    ws1 = torch.empty((b, 2 * r, 2 * wd, mid), dtype=dt, device=dev)
    ws2 = torch.empty((b, 2 * r, 2 * wd, mid), dtype=dt, device=dev)
    out = torch.empty((b, 4 * r, 4 * wd, k), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().pe_fused_decoder(
            DTYPE_CODES[dt], latent.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), w4.data_ptr(), b4.data_ptr(),
            ws1.data_ptr(), ws2.data_ptr(), out.data_ptr(),
            b, r, wd, cin, mid, k, alpha, CONV_KERNEL_CODES[conv_kernel], stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_decoder kernel: CUDA error {rc}")
    fused_decoder.launches += 1
    fused_decoder.convs_by_kernel[conv_kernel] += 2
    return out


fused_decoder.launches = 0
fused_decoder.convs_by_kernel = {"fma": 0, "mma": 0}
