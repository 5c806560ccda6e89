"""Atrous CNN encoder / transposed-conv decoder, torch flavour (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/models/layers.py``
``EncoderAtrous``/``DecoderUp`` with ``flavor='torch'`` (reference:
pytorch/CNNs.py:9-157): LeakyReLU 0.1, residual skips between consecutive
convs, 2x2 max-pool + LeakyReLU after encoder stages 1-2, and a
stride-2 / 1 / 1 / 2 ConvTranspose2d decoder with the reference's
``padding=1, output_padding=1`` crop. The modules work on NCHW tensors;
``BasicNet`` (models/cnn.py) keeps the public NHWC contract.

Parameter names follow the flax tree (conv1..conv9, deconv1..deconv4) so the
weight bridge (weights.py) maps one onto the other by name. Inference only:
the forward raises in training mode, because dropout needs the train step's
``torch.Generator`` (ROADMAP Queue A item 6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

TORCH_ALPHA = 0.1  # pytorch/CNNs.py:21


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, TORCH_ALPHA)


def _check_flavor(flavor: str, kernel_size: int) -> None:
    if flavor != "torch":
        raise NotImplementedError(
            f"arch_flavor={flavor!r}: the port has the torch flavour only; "
            "the tf flavour is ROADMAP Queue A item 2"
        )
    if kernel_size % 2 == 0:
        raise NotImplementedError(
            f"kernel_size={kernel_size}: even kernels (asymmetric SAME pads) "
            "are not ported (ROADMAP Queue A item 2)"
        )


def _check_eval(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            "training-mode forward (dropout) is the train-step slice, "
            "ROADMAP Queue A item 6; call .eval() to serve"
        )


class EncoderAtrous(nn.Module):
    """Dilated-conv encoder, /4 downsample: 3 stages of 3 convs at
    filters, 2x, 4x (pytorch/CNNs.py:73-88)."""

    def __init__(
        self, in_channels: int, filters: int = 64, kernel_size: int = 3,
        dilation: int = 2, flavor: str = "torch",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        _check_flavor(flavor, kernel_size)
        chans = in_channels
        for stage, mult in enumerate((1, 2, 4)):
            f = filters * mult
            for i in range(3):
                self.add_module(
                    f"conv{3 * stage + i + 1}",
                    nn.Conv2d(
                        chans if i == 0 else f, f, kernel_size,
                        padding="same", dilation=dilation, dtype=dtype,
                    ),
                )
            chans = f
        self.out_channels = chans

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_eval(self)
        for stage in range(3):
            conv = [getattr(self, f"conv{3 * stage + i}") for i in (1, 2, 3)]
            x1 = leaky(conv[0](x))
            x2 = leaky(conv[1](x1)) + x1
            x3 = leaky(conv[2](x2)) + x2
            if stage < 2:
                # flax max_pool(2, 2, SAME) == ceil_mode for odd sizes
                x = leaky(F.max_pool2d(x3, 2, 2, ceil_mode=True))
            else:
                x = x3
        return x


class DecoderUp(nn.Module):
    """Transposed-conv decoder: (C, h, w) -> (out_channels, 4h, 4w).
    deconv/2x -> two same-size deconvs with skips -> deconv/2x head,
    LeakyReLU(0.1) on every layer including the head
    (pytorch/CNNs.py:151-157)."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_size: int = 3,
        flavor: str = "torch", dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        _check_flavor(flavor, kernel_size)
        half = in_channels // 2
        k = kernel_size

        def up(cin: int, cout: int) -> nn.ConvTranspose2d:
            # the reference's crop: padding=1, output_padding=1 for any k
            return nn.ConvTranspose2d(
                cin, cout, k, stride=2, padding=1, output_padding=1,
                dtype=dtype,
            )

        def same(c: int) -> nn.ConvTranspose2d:
            return nn.ConvTranspose2d(c, c, k, padding=(k - 1) // 2,
                                      dtype=dtype)

        self.deconv1 = up(in_channels, half)
        self.deconv2 = same(half)
        self.deconv3 = same(half)
        self.deconv4 = up(half, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_eval(self)
        x1 = leaky(self.deconv1(x))
        x2 = leaky(self.deconv2(x1)) + x1
        x3 = leaky(self.deconv3(x2)) + x2
        return leaky(self.deconv4(x3))
