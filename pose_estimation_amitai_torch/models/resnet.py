"""ResNet families of the PyTorch port: ``ResNetHeatmapNet`` (a ResNet50
trunk and five stride-2 transposed convs) and ``GPTResNet`` (a residual
encoder-decoder with skip additions).

Counterpart of ``pose_estimation_amitai_tpu/models/resnet.py`` (reference:
tensorflow/Network.py:377-414, a keras ResNet50 feeding 5 deconvs;
pytorch/NNs warehouse/NNs.py:70-160, the residual encoder-decoder). Modules
and parameters carry flax's names (``encoder.stage{s}_block{b}.conv1``,
``stem_bn``, ``conv{s}_block{b}_{j}_conv``, ``deconv{i}``, ``head``,
``enc1_block0``, ``up4``, ...) so the weight bridge (weights.py) walks one
tree onto the other; BatchNorm is flax's (models/norm.py), its running
averages buffers.

Every conv pads as its flax twin: ``"SAME"`` from the input's size at any
stride (models/layers.py ``same_pads``: a 7x7/2 stem on 192 rows pads (2,
3), the 3x3/2 max-pool on 96 pads (0, 1) with -inf), ``"VALID"``, or the
fixed pads the ``torch`` and ``tf`` flavours pin ((3, 3) stem, (1, 1)
pool and stride-2 3x3). Dtypes follow flax's casts: a conv runs in the
compute dtype (its input and weight cast to it), BatchNorm in float32, and
a residual sum takes whatever dtype its two sides have there.

Modules work on NCHW tensors; the models take NHWC frames and return NHWC
float32 maps, the JAX contract.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    TF_ALPHA, Deconv, at_least_f32, conv, deconv_same_pads, leaky, same_pads,
)
from .norm import BatchNorm

KERAS_EPSILON = 1.001e-5  # keras applications' ResNet BatchNorm epsilon
FLAVORS = ("tpu", "torch", "tf")


class PadConv(nn.Conv2d):
    """A conv padded as flax's ``nn.Conv(padding=...)``: ``"SAME"`` (from the
    input's size), ``"VALID"``, or ``(low, high)`` on both axes. Its input
    is cast to ``dtype``, as flax's ``nn.Conv(dtype=)`` casts it."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: str | tuple[int, int] = "SAME", bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, stride=stride, bias=bias, dtype=dtype)
        self.dtype = dtype
        self.flax_padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        k, s = self.kernel_size[0], self.stride[0]
        if self.flax_padding == "VALID":
            return conv(self, x)
        if self.flax_padding == "SAME":
            (hl, hh), (wl, wh) = (same_pads(n, k, s) for n in x.shape[-2:])
        else:
            (hl, hh), (wl, wh) = self.flax_padding, self.flax_padding
        if hl == hh and wl == wh:
            return F.conv2d(x, self.weight.to(x.dtype),
                            None if self.bias is None else self.bias.to(x.dtype),
                            self.stride, (hl, wl))
        return conv(self, F.pad(x, (wl, wh, hl, hh)))


def max_pool_3x3_s2(x: torch.Tensor, padding: str | tuple[int, int]) -> torch.Tensor:
    """flax ``max_pool(x, (3, 3), strides=(2, 2), padding=...)``: pads of
    -inf, ``"SAME"`` from the size or fixed (low, high)."""
    if padding == "SAME":
        (hl, hh), (wl, wh) = (same_pads(n, 3, 2) for n in x.shape[-2:])
    else:
        (hl, hh), (wl, wh) = padding, padding
    if hl == hh and wl == wh:
        return F.max_pool2d(x, 3, 2, padding=(hl, wl))
    return F.max_pool2d(F.pad(x, (wl, wh, hl, hh), value=float("-inf")), 3, 2)


def _check_flavor(flavor: str) -> None:
    if flavor not in FLAVORS:
        raise ValueError(f"resnet_flavor={flavor!r}; expected one of {FLAVORS}")


class BottleneckBlock(nn.Module):
    """ResNet v1.5 bottleneck: 1x1 -> 3x3 at the stride -> 1x1, 4x
    expansion, a 1x1 + BN projection where the shape changes. ``torch``
    pins the stride-2 3x3's pads to (1, 1) (torchvision's), ``tpu`` keeps
    ``"SAME"``. Takes its input in the compute dtype; returns float32."""

    def __init__(self, cin: int, features: int, stride: int = 1, flavor: str = "tpu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        pad3 = (1, 1) if flavor == "torch" else "SAME"
        self.conv1 = PadConv(cin, features, 1, dtype=dtype)
        self.bn1 = BatchNorm(features)
        self.conv2 = PadConv(features, features, 3, stride, pad3, dtype=dtype)
        self.bn2 = BatchNorm(features)
        self.conv3 = PadConv(features, 4 * features, 1, dtype=dtype)
        self.bn3 = BatchNorm(4 * features)
        self.project = cin != 4 * features or stride != 1
        if self.project:
            self.conv_proj = PadConv(cin, 4 * features, 1, stride, dtype=dtype)
            self.bn_proj = BatchNorm(4 * features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y.to(self.dtype))))
        y = self.bn3(self.conv3(y.to(self.dtype)))
        residual = self.bn_proj(self.conv_proj(x)) if self.project else x
        return F.relu(y + residual)


class ResNet50Encoder(nn.Module):
    """ResNet50 trunk, output stride 32 (192 -> 6x6x2048): a 7x7/2 stem, BN,
    ReLU, a 3x3/2 max-pool, then ``stage_sizes`` bottleneck blocks at 64,
    128, 256, 512 features. ``torch`` pins torchvision's (3, 3) stem and
    (1, 1) pool pads; ``tpu`` keeps ``"SAME"``."""

    def __init__(self, in_channels: int, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 flavor: str = "tpu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.torch_pads = flavor == "torch"
        self.stem = PadConv(in_channels, 64, 7, 2, (3, 3) if self.torch_pads else "SAME",
                            dtype=dtype)
        self.stem_bn = BatchNorm(64)
        self.blocks = []
        cin = 64
        for stage, blocks in enumerate(stage_sizes):
            for block in range(blocks):
                name = f"stage{stage}_block{block}"
                stride = 2 if stage > 0 and block == 0 else 1
                self.add_module(name, BottleneckBlock(cin, 64 * 2**stage, stride, flavor, dtype))
                self.blocks.append(name)
                cin = 4 * 64 * 2**stage
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem(x.to(self.dtype))))
        x = max_pool_3x3_s2(x, (1, 1) if self.torch_pads else "SAME")
        for name in self.blocks:
            x = getattr(self, name)(x.to(self.dtype))
        return x


class KerasResNet50Encoder(nn.Module):
    """keras-applications ResNet50 v1 trunk (the ``tf`` flavour): biased
    convs, BN epsilon 1.001e-5, the stride on each stage's first 1x1 conv,
    1x1 convs ``"VALID"``, (3, 3) stem and (1, 1) pool pads; layers named
    ``conv1_conv``, ``conv{s}_block{b}_{j}_conv`` / ``_bn`` as keras names
    them. Widths ``stem_features * 2**stage``, 4x expansion."""

    def __init__(self, in_channels: int, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 stem_features: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype

        def layer(name: str, cin: int, cout: int, k: int, stride: int, pad) -> None:
            self.add_module(f"{name}_conv", PadConv(cin, cout, k, stride, pad, True, dtype))
            self.add_module(f"{name}_bn", BatchNorm(cout, KERAS_EPSILON))

        layer("conv1", in_channels, stem_features, 7, 2, (3, 3))
        self.blocks: list[tuple[str, bool]] = []
        cin = stem_features
        for stage, blocks in enumerate(stage_sizes):
            filters = stem_features * 2**stage
            for b in range(1, blocks + 1):
                name = f"conv{stage + 2}_block{b}"
                stride = 2 if stage > 0 and b == 1 else 1
                if b == 1:
                    layer(f"{name}_0", cin, 4 * filters, 1, stride, "VALID")
                layer(f"{name}_1", cin, filters, 1, stride, "VALID")
                layer(f"{name}_2", filters, filters, 3, 1, "SAME")
                layer(f"{name}_3", filters, 4 * filters, 1, 1, "VALID")
                self.blocks.append((name, b == 1))
                cin = 4 * filters
        self.out_channels = cin

    def _conv_bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self._conv_bn("conv1", x.to(self.dtype)))
        x = max_pool_3x3_s2(x, (1, 1))
        for name, first in self.blocks:
            xin = x.to(self.dtype)
            shortcut = self._conv_bn(f"{name}_0", xin) if first else x
            y = F.relu(self._conv_bn(f"{name}_1", xin))
            y = F.relu(self._conv_bn(f"{name}_2", y.to(self.dtype)))
            y = self._conv_bn(f"{name}_3", y.to(self.dtype))
            x = F.relu(y + shortcut)
        return x


class BasicResBlock(nn.Module):
    """Basic residual block: 3x3 BN ReLU 3x3 BN plus the input, or its 1x1
    + BN projection where the shape changes (pytorch/NNs warehouse/
    NNs.py:140-160). The convs run in the compute dtype; the skip adds the
    input as it came."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = PadConv(cin, features, 3, stride, dtype=dtype)
        self.bn1 = BatchNorm(features)
        self.conv2 = PadConv(features, features, 3, dtype=dtype)
        self.bn2 = BatchNorm(features)
        self.project = cin != features or stride != 1
        if self.project:
            self.conv_proj = PadConv(cin, features, 1, stride, dtype=dtype)
            self.bn_proj = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y.to(self.dtype)))
        residual = self.bn_proj(self.conv_proj(x)) if self.project else x
        return F.relu(y + residual)


@lru_cache(maxsize=None)
def _cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of ``jax.image.resize(method="cubic")``
    along one axis (``compute_weight_mat``): Keys' kernel with a = -0.5 at
    the sample points (o + 0.5) / scale - 0.5, each column divided by its
    sum, so taps outside the input drop out and the rest renormalise."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), w)
    w = np.where(x >= 2.0, f32(0.0), w).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def cubic_resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """NCHW ``x`` resized to ``size`` as ``jax.image.resize(..., "cubic")``
    does, in float32: two (in, out) weight matrices applied by einsum. Not
    ``F.interpolate(mode="bicubic")``, whose kernel has a = -0.75 and which
    clamps the taps at the border."""
    (h, w), (oh, ow) = x.shape[-2:], size
    x = at_least_f32(x)
    wh = torch.tensor(_cubic_weights(h, oh), dtype=x.dtype, device=x.device)
    ww = torch.tensor(_cubic_weights(w, ow), dtype=x.dtype, device=x.device)
    return torch.einsum("bchw,hH,wW->bcHW", x, wh, ww)


class GPTResNet(nn.Module):
    """Residual encoder-decoder with skip additions (pytorch/NNs warehouse/
    NNs.py:70-136): a 7x7/2 stem, BN, ReLU, 3x3/2 max-pool, four stages of
    two basic blocks (64, 128, 256, 512), four 2x2/2 transposed convs
    (``up4`` .. ``up1``), the first three each cropped to its skip, added
    to it and followed by a stage, a 1x1 head, and a cubic resize to the
    input's size (:func:`cubic_resize`)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.out_channels = out_channels
        self.dtype = dtype
        self.stem = PadConv(in_channels, 64, 7, 2, dtype=dtype)
        self.stem_bn = BatchNorm(64)

        def stage(name: str, cin: int, feat: int, stride: int) -> None:
            self.add_module(f"{name}_block0", BasicResBlock(cin, feat, stride, dtype))
            self.add_module(f"{name}_block1", BasicResBlock(feat, feat, 1, dtype))

        stage("enc1", 64, 64, 1)
        stage("enc2", 64, 128, 2)
        stage("enc3", 128, 256, 2)
        stage("enc4", 256, 512, 2)
        for name, cin, feat in (("up4", 512, 256), ("up3", 256, 128), ("up2", 128, 64),
                                ("up1", 64, 64)):
            self.add_module(name, Deconv(cin, feat, 2, 2, (1, 1), dtype))
        stage("dec4", 256, 256, 1)
        stage("dec3", 128, 128, 1)
        stage("dec2", 64, 64, 1)
        self.head = PadConv(64, out_channels, 1, bias=True, dtype=dtype)

    def _stage(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"{name}_block1")(getattr(self, f"{name}_block0")(x))

    def _up(self, name: str, x: torch.Tensor, like: torch.Tensor | None = None) -> torch.Tensor:
        y = getattr(self, name)(x)
        return y if like is None else y[..., : like.shape[-2], : like.shape[-1]]

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        h, w = x.shape[1:3]
        y = self.stem(x.to(self.dtype).permute(0, 3, 1, 2))
        y = max_pool_3x3_s2(F.relu(self.stem_bn(y)), "SAME")
        skip1 = y = self._stage("enc1", y)
        skip2 = y = self._stage("enc2", y)
        skip3 = y = self._stage("enc3", y)
        y = self._stage("enc4", y)
        y = self._stage("dec4", self._up("up4", y, skip3) + skip3)
        y = self._stage("dec3", self._up("up3", y, skip2) + skip2)
        y = self._stage("dec2", self._up("up2", y, skip1) + skip1)
        y = self.head(self._up("up1", y))
        return cubic_resize(y, (h, w)).permute(0, 2, 3, 1)


class ResNetHeatmapNet(nn.Module):
    """ResNet50 trunk + five channel-halving stride-2 ``"SAME"`` transposed
    convs (``deconv1`` .. ``deconv4``, ``head``), LeakyReLU 0.01 after each,
    cropped to the input's size (tensorflow/Network.py:377-414). ``flavor``:
    ``tpu`` (``"SAME"`` trunk), ``torch`` (torchvision's pads) or ``tf``
    (the keras v1 trunk, :class:`KerasResNet50Encoder`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 flavor: str = "tpu", stem_features: int = 64,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        _check_flavor(flavor)
        self.out_channels = out_channels
        self.flavor = flavor
        self.dtype = dtype
        if flavor == "tf":
            self.encoder = KerasResNet50Encoder(in_channels, stage_sizes, stem_features, dtype)
        else:
            self.encoder = ResNet50Encoder(in_channels, stage_sizes, flavor, dtype)
        k, pads = kernel_size, deconv_same_pads(kernel_size, 2)
        feat = self.encoder.out_channels
        for i in range(4):
            self.add_module(f"deconv{i + 1}", Deconv(feat, feat // 2, k, 2, pads, dtype))
            feat //= 2
        self.head = Deconv(feat, out_channels, k, 2, pads, dtype)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        h, w = x.shape[1:3]
        y = self.encoder(x.permute(0, 3, 1, 2))
        for i in range(4):
            y = leaky(getattr(self, f"deconv{i + 1}")(y), TF_ALPHA)
        y = self.head(y)[..., :h, :w]
        return at_least_f32(leaky(y, TF_ALPHA)).permute(0, 2, 3, 1)
