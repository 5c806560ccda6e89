"""``BasicNet``, the flagship per-wing heatmap model (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/models/cnn.py`` ``BasicNet``
(reference: pytorch/CNNs.py:160-186, the ``MODEL_18_POINTS_PER_WING`` path).
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import DecoderUp, EncoderAtrous


class BasicNet(nn.Module):
    """Single encoder-decoder heatmap regressor.

    Takes NHWC frames (B, H, W, in_channels), returns NHWC float32 maps
    (B, H, W, out_channels), the JAX contract. Parameters are created in
    ``dtype`` and every conv runs in ``dtype``, each weight cast to it where
    it is applied (models/layers.py ``conv``): serving holds bf16 weights
    (the JAX module's cast of its f32 params to bf16 at every apply rounds
    them the same way once), training passes float32 ones
    (train/loop.py). In training mode the encoder's dropout draws from
    ``generator``.
    """

    def __init__(
        self, in_channels: int, out_channels: int, filters: int = 64,
        kernel_size: int = 3, dilation: int = 2, flavor: str = "torch",
        dtype: torch.dtype = torch.bfloat16, dropout: float = 0.5,
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
        )
        self.decoder = DecoderUp(
            self.encoder.out_channels, out_channels, kernel_size, flavor,
            dtype,
        )

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        y = self.decoder(self.encoder(h, generator))
        return y.permute(0, 2, 3, 1).float()
