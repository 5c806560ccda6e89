"""CNN heatmap models: ``BasicNet``, the coarse and coarse-to-fine stacks,
and the two-wings net (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/models/cnn.py`` (reference:
pytorch/CNNs.py:160-186 ``BasicNet``; tensorflow/Network.py:127-198
``basic_nn``/``coarse_per_wing``/``C2F_per_wing``; tensorflow/Network.py:200-243
``two_wings_net``). Submodule names follow the flax scopes (``encoder``,
``decoder``, ``coarse``, ``fine``, ``shared_encoder``, ``shared_decoder``),
so the weight bridge walks one tree onto the other.

Every model takes NHWC frames (B, H, W, C) and returns NHWC float32 maps,
the JAX contract, and takes the ``torch.Generator`` its training-mode
dropout draws from.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import DecoderUp, EncoderAtrous


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).float()


class BasicNet(nn.Module):
    """Single encoder-decoder heatmap regressor, the flagship per-wing model.

    Parameters are created in ``dtype`` and every conv runs in ``dtype``,
    each weight cast to it where it is applied (models/layers.py ``conv``):
    serving holds bf16 weights (the JAX module's cast of its f32 params to
    bf16 at every apply rounds them the same way once), training passes
    float32 ones (train/loop.py).
    """

    def __init__(
        self, in_channels: int, out_channels: int, filters: int = 64,
        kernel_size: int = 3, dilation: int = 2, flavor: str = "torch",
        dtype: torch.dtype = torch.bfloat16, dropout: float = 0.5,
        num_blocks: int = 2,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.filters = filters
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.flavor = flavor
        self.dtype = dtype
        self.encoder = EncoderAtrous(
            in_channels, filters, kernel_size, dilation, flavor, dtype, dropout,
            num_blocks,
        )
        self.decoder = DecoderUp(
            self.encoder.out_channels, out_channels, kernel_size, flavor,
            dtype, filters, num_blocks,
        )

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        return _nhwc(self.decoder(self.encoder(_nchw(x, self.dtype), generator)))


class CoarsePerWing(BasicNet):
    """Coarse stage: ``BasicNet`` forced to the tf flavour and, by default,
    a 3-block (8x) pyramid (tensorflow/Network.py:147-167, ``num_blocks = 3
    # important!``)."""

    def __init__(self, in_channels: int, out_channels: int, *, num_blocks: int = 3,
                 **kw):
        super().__init__(in_channels, out_channels, flavor="tf",
                         num_blocks=num_blocks, **kw)


class C2FPerWing(nn.Module):
    """Coarse-to-fine stack: a frozen coarse model whose maps are
    concatenated onto the input of a fine ``BasicNet``
    (tensorflow/Network.py:169-198).

    The coarse stage always runs as in evaluation (no dropout) and under
    ``torch.no_grad`` (flax's ``stop_gradient``): its parameters, named
    ``coarse.*`` (:attr:`frozen_prefixes`), get no gradient, and the train
    step leaves them out of Adam. The trainer loads them from
    ``coarse_model_path``.
    """

    frozen_prefixes = ("coarse.",)

    def __init__(
        self, in_channels: int, out_channels: int, coarse_out_channels: int = 7,
        filters: int = 64, kernel_size: int = 3, dilation: int = 2,
        dropout: float = 0.5, num_blocks: int = 2,
        coarse_filters: int | None = None, coarse_num_blocks: int = 3,
        flavor: str = "tf", dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.out_channels = out_channels
        self.dtype = dtype
        self.coarse = CoarsePerWing(
            in_channels, coarse_out_channels, filters=coarse_filters or filters,
            kernel_size=kernel_size, dilation=dilation, dropout=dropout,
            num_blocks=coarse_num_blocks, dtype=dtype)
        self.fine = BasicNet(
            in_channels + coarse_out_channels, out_channels, filters, kernel_size,
            dilation, flavor, dtype, dropout, num_blocks)

    def train(self, mode: bool = True) -> "C2FPerWing":
        super().train(mode)
        self.coarse.train(False)  # flax: coarse(x, train=False)
        return self

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        with torch.no_grad():
            coarse_maps = self.coarse(x)
        return self.fine(torch.cat([x, coarse_maps.to(x.dtype)], dim=-1), generator)


class TwoWingsNet(nn.Module):
    """Shared encoder over two wing views, cross-wing concat decoder
    (tensorflow/Network.py:200-243).

    Input (H, W, T + 2): T time channels and one mask channel per wing; wing
    i sees the time channels plus its own mask (channels [0..T-1, T+i]). The
    decoder of wing i takes concat(enc_i, enc_j); the two wings' maps
    (``out_channels // 2`` each) are concatenated.
    """

    def __init__(
        self, in_channels: int, out_channels: int, filters: int = 64,
        kernel_size: int = 3, dilation: int = 2, dropout: float = 0.5,
        num_blocks: int = 2, flavor: str = "tf",
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.out_channels = out_channels
        self.dtype = dtype
        self.shared_encoder = EncoderAtrous(
            in_channels - 1, filters, kernel_size, dilation, flavor, dtype,
            dropout, num_blocks)
        self.shared_decoder = DecoderUp(
            2 * self.shared_encoder.out_channels, out_channels // 2, kernel_size,
            flavor, dtype, filters, num_blocks)

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        t = x.shape[-1] - 2
        codes = [self.shared_encoder(_nchw(x[..., list(range(t)) + [t + i]], self.dtype),
                                     generator) for i in (0, 1)]
        maps = [self.shared_decoder(torch.cat([codes[i], codes[1 - i]], dim=1))
                for i in (0, 1)]
        return _nhwc(torch.cat(maps, dim=1))
