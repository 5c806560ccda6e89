"""Exact ``int8 x int8 -> int32`` convolutions in plain PyTorch.

Counterparts of the three ``lax.conv_general_dilated`` forms of
``pose_estimation_amitai_tpu/models/quantized.py`` (``_conv``,
``_deconv_s1``, ``_deconv_s2`` with ``preferred_element_type=int32``), which
the JAX package leaves to XLA outside any Pallas kernel; here they go to the
library's convolution.

PyTorch has no int8 convolution on CUDA and none for int32 on the CPU, so
the products run in float64: every tap product and partial sum is an integer
below 2**53, hence exact whatever the order of summation. float32 would not
do: a 3x3x256 tap sum reaches 9 * 256 * 127**2 = 3.7e7 > 2**24. The result is
rounded before the cast so that an algorithm that works through transforms
(FFT, Winograd) still lands on the integer.

Tensors keep the JAX contracts: x NHWC (B, H, W, Cin) int8, weights HWIO
(kh, kw, Cin, Cout) int8 with odd kh = kw; the result is an NHWC int32 view
(channels-first in memory).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _nchw64(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).to(torch.float64)


def _nhwc_s32(y: torch.Tensor) -> torch.Tensor:
    return y.round().to(torch.int32).permute(0, 2, 3, 1)


def conv_s32(x: torch.Tensor, w: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """SAME dilated conv, stride 1: (B, H, W, Cin) -> (B, H, W, Cout) int32."""
    pad = dilation * (w.shape[0] - 1) // 2
    y = F.conv2d(_nchw64(x), w.permute(3, 2, 0, 1).to(torch.float64),
                 padding=pad, dilation=dilation)
    return _nhwc_s32(y)


def deconv_s1_s32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """flax ConvTranspose(k3, stride 1, SAME) on its own HWIO kernel: a plain
    unflipped SAME conv."""
    return conv_s32(x, w)


def deconv_s2_s32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Torch-flavour stride-2 ConvTranspose on a flax HWIO kernel (the
    lhs-dilated conv with padding (1, 2)): (B, H, W, Cin) -> (B, 2H, 2W,
    Cout) int32. ``ConvTranspose2d(k3, s2, padding=1, output_padding=1)``
    correlates with the kernel flipped in space, so the kernel is flipped."""
    wt = torch.flip(w, (0, 1)).permute(2, 3, 0, 1).to(torch.float64)
    y = F.conv_transpose2d(_nchw64(x), wt, stride=2, padding=1, output_padding=1)
    return _nhwc_s32(y)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool of an NHWC tensor of any dtype (even H and W)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
