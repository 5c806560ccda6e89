"""Model families: each module gives, for a configuration of its family,
the flax-layout leaves to draw (``leaves``), the plain float32 reference
forward (``forward``), the work counts (``flops_per_frame``,
``kernel_bounds``) and how its served ``val`` is scaled (``VAL_MODE``).

The references are plain PyTorch and import nothing of the port: a conv
is ``F.conv2d`` on the flax HWIO kernel laid out OIHW, a transposed conv
is flax's ``ConvTranspose`` as it is defined (the input dilated by the
stride, padded, then correlated with the kernel as it is). ``quant`` is
applied to the operands of every conv and matrix product: the identity for
the reference, a lower precision for the control (``portbench.compare``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv_same(x: torch.Tensor, k_hwio: torch.Tensor, b: torch.Tensor, dilation: int,
              quant) -> torch.Tensor:
    """Stride-1 ``"SAME"`` conv of NCHW ``x`` (flax's pads: the odd one high)."""
    k = k_hwio.shape[0]
    total = dilation * (k - 1)
    lo, hi = total // 2, total - total // 2
    x = F.pad(x, (lo, hi, lo, hi))
    return F.conv2d(quant(x), quant(k_hwio.permute(3, 2, 0, 1)), b, dilation=dilation)


def conv_transpose(x: torch.Tensor, k_hwio: torch.Tensor, b: torch.Tensor, stride: int,
                   pads: tuple[int, int], quant) -> torch.Tensor:
    """flax ``ConvTranspose`` (``transpose_kernel=False``) of NCHW ``x``:
    zeros between the input's pixels (``stride - 1`` of them), ``pads``
    (low, high) around, then a correlation with the kernel unflipped."""
    n, c, h, w = x.shape
    if stride > 1:
        y = x.new_zeros((n, c, (h - 1) * stride + 1, (w - 1) * stride + 1))
        y[:, :, ::stride, ::stride] = x
        x = y
    lo, hi = pads
    x = F.pad(x, (lo, hi, lo, hi))
    return F.conv2d(quant(x), quant(k_hwio.permute(3, 2, 0, 1)), b)


def leaky(x: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: ``x * (u < keep) / keep``, u uniform from ``gen``
    in ``x``'s shape (the draw the port's train step makes at this point)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(tuple(x.shape), generator=gen, device=x.device)
    return x * (u < keep) / keep
