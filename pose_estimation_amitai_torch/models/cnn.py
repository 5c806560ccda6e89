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
    (B, H, W, out_channels), the JAX contract. Inference only: dropout
    (``cfg.dropout_ratio``) comes with the train step, ROADMAP Queue A
    item 6. Parameters are held and the convs run in ``dtype`` (the JAX
    module's bf16 compute over f32 params casts the same weights to bf16
    at every apply; holding them in bf16 rounds them the same way once).
    """

    def __init__(
        self, in_channels: int, out_channels: int, filters: int = 64,
        kernel_size: int = 3, dilation: int = 2, flavor: str = "torch",
        dtype: torch.dtype = torch.bfloat16,
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
            in_channels, filters, kernel_size, dilation, flavor, dtype,
        )
        self.decoder = DecoderUp(
            self.encoder.out_channels, out_channels, kernel_size, flavor,
            dtype,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        y = self.decoder(self.encoder(h))
        return y.permute(0, 2, 3, 1).float()
