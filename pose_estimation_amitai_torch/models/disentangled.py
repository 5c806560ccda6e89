"""The geometry-aware 4-camera disentanglement model (FTL), PyTorch port.

Counterpart of ``pose_estimation_amitai_tpu/models/disentangled.py``
(reference: pytorch/CNNs.py:240-352, ``FourCamerasDisentanglement``): a
shared per-view encoder, a 1x1 ``rearrange1`` to a 300-channel latent,
inverse FTL through each view's pseudo-inverse camera into a 400-channel
canonical space, two 1x1 fusion convs with BatchNorm over the four canonical
latents, FTL back through each view's camera, a shared BatchNorm ``bn3``
(one module, applied to each view in turn), a 1x1 ``rearrange2``, the
encoder's output added as a skip, and a shared decoder.

The cameras come in beside the frames, one row per sample (data/pipeline.py
builds them per crop): ``forward(x, P, P_inv)``. The FTL math is
ops/geometry.py's ``ftl_project`` / ``ftl_inverse``; it runs in float32, as
do the BatchNorms, and the convs in the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.geometry import ftl_inverse, ftl_project
from .layers import Conv, DecoderUp, EncoderAtrous, at_least_f32
from .norm import BatchNorm

NUM_CAMS = 4


def _nhwc_ftl(fn, t: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """``fn`` (an NHWC FTL) on an NCHW tensor: channels grouped per pixel."""
    return fn(t.permute(0, 2, 3, 1), cam).permute(0, 3, 1, 2)


def _raw_ftl(t: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """The reference's FTL on an NCHW tensor (pytorch/CNNs.py:335, 348): the
    (B, C, h, w) memory read as (B, h, w, C / j, j), j the camera's
    columns, which mixes channels and positions rather than grouping
    channels, then written back the same way."""
    b, c, h, w = t.shape
    i, j = cam.shape[-2:]
    z = t.reshape(b, h, w, c // j, j)
    out = torch.einsum("bhwgj,bij->bhwgi", z, cam)
    return out.reshape(b, c // j * i, h, w)


class FourCamDisentangled(nn.Module):
    """Shared encoder, canonical-space fusion through FTL, shared decoder.

    ``forward(x, P, P_inv)``: x (B, H, W, 4 Cc) NHWC frames, the four views'
    channels side by side; P (B, 4, 3, 4) and P_inv (B, 4, 4, 3) per-sample
    cameras. Returns (B, H, W, out_channels) float32 maps, the four views'
    side by side. ``ref_ftl_layout``: the reference's raw reinterpret of the
    NCHW latent instead of the per-pixel channel grouping, which only the
    reference's checkpoints need."""

    def __init__(
        self, in_channels: int, out_channels: int, filters: int = 64,
        kernel_size: int = 3, dilation: int = 2, dropout: float = 0.5,
        num_blocks: int = 2, flavor: str = "torch", latent_3d_channels: int = 300,
        dtype: torch.dtype = torch.bfloat16, ref_ftl_layout: bool = False,
    ):
        super().__init__()
        self.out_channels = out_channels
        self.dtype = dtype
        self.ref_ftl_layout = ref_ftl_layout
        self.flavor = flavor
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.shared_encoder = EncoderAtrous(
            in_channels // NUM_CAMS, filters, kernel_size, dilation, flavor, dtype,
            dropout, num_blocks)
        enc = self.shared_encoder.out_channels
        canon = latent_3d_channels // 3 * 4  # 400

        def conv1x1(cin: int, cout: int) -> Conv:
            return Conv(cin, cout, 1, dtype=dtype)

        self.rearrange1 = conv1x1(enc, latent_3d_channels)
        self.rearrange2 = conv1x1(latent_3d_channels, enc)
        self.fusion1 = conv1x1(NUM_CAMS * canon, canon)
        self.fusion2 = conv1x1(canon, canon)
        self.bn1 = BatchNorm(canon)
        self.bn2 = BatchNorm(canon)
        self.bn3 = BatchNorm(latent_3d_channels)
        self.shared_decoder = DecoderUp(enc, out_channels // NUM_CAMS, kernel_size, flavor,
                                        dtype, filters, num_blocks)

    def _ftl(self, fn, t: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
        """``fn`` at least in float32, ``t``'s precision where wider."""
        t = at_least_f32(t)
        cam = cam.to(t.dtype)
        return _raw_ftl(t, cam) if self.ref_ftl_layout else _nhwc_ftl(fn, t, cam)

    def forward(
        self, x: torch.Tensor, P: torch.Tensor, P_inv: torch.Tensor,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        cc = x.shape[-1] // NUM_CAMS
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        encs = [self.shared_encoder(x[:, i * cc : (i + 1) * cc], generator)
                for i in range(NUM_CAMS)]
        canonical = [
            self._ftl(ftl_inverse, self.rearrange1(e), P_inv[:, i]).to(self.dtype)
            for i, e in enumerate(encs)
        ]
        fusion = F.relu(self.bn1(self.fusion1(torch.cat(canonical, dim=1))))
        fusion = F.relu(self.bn2(self.fusion2(fusion.to(self.dtype))))
        outs = []
        for i, e in enumerate(encs):
            ent = F.relu(self.bn3(self._ftl(ftl_project, fusion, P[:, i])))
            ent = self.rearrange2(ent.to(self.dtype))
            outs.append(self.shared_decoder(ent + e))
        return at_least_f32(torch.cat(outs, dim=1)).permute(0, 2, 3, 1)
