"""Atrous CNN encoder / transposed-conv decoder, both flavours (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/models/layers.py``
``EncoderAtrous``/``DecoderUp``:

* ``flavor='torch'`` (reference: pytorch/CNNs.py:9-157): LeakyReLU 0.1,
  residual skips between consecutive convs, 2x2 max-pool + LeakyReLU after
  encoder stages 1-2, and a stride-2 / 1 / 1 / 2 transposed-conv decoder
  with the reference's ``padding=1, output_padding=1`` crop;
* ``flavor='tf'`` (reference: tensorflow/Network.py:416-474): LeakyReLU
  0.01, no skips, ``num_blocks`` stages of [conv, conv, linear conv, 2x2
  max-pool, ReLU, dropout], a three-conv bottleneck, then ``num_blocks - 1``
  blocks of [stride-2 deconv, conv, conv] and a linear stride-2 deconv head.
  Its deconvs follow flax's ``ConvTranspose(padding="SAME")``, which crops
  the full transposed output on the bottom/right, not the torch one's
  top/left.

Every conv pads as flax's ``"SAME"`` does, even kernel sizes included: a
conv ``(k - 1) * d // 2`` low and the rest high; a transposed conv by
``lax.conv_transpose``'s rule (:func:`deconv_same_pads`). Where the two
sides differ the conv pads explicitly (``F.pad``) and the transposed conv
crops its output.

The modules work on NCHW tensors; the models (models/cnn.py,
models/multicam.py) keep the public NHWC contract. Parameter names follow
the flax tree (conv1..conv9, deconv1..deconv4; block{b}_conv{i},
bottleneck_conv{i}, block{b}_deconv, head_deconv) so the weight bridge
(weights.py) maps one onto the other by name. Each layer (``Conv``,
``Deconv``, ``Dense``) casts its input to its ``dtype`` and its weight and
bias to the activations' dtype where it applies them, as flax's
``dtype=bf16, param_dtype=float32`` does, and every layer is applied by
calling the module, so what a layer receives is what its flax twin
receives (models/quantized_generic.py calibrates on it): the train step passes float32
parameters to a bf16 module (``torch.func.functional_call``), and a module
that holds parameters in its compute dtype computes as it always did. In
training mode the encoder applies dropout where the JAX one does, drawing
from the ``torch.Generator`` the caller passes.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import draws

TF_ALPHA = 0.01  # tensorflow/Network.py:11
TORCH_ALPHA = 0.1  # pytorch/CNNs.py:21
FLAVORS = ("torch", "tf")


def leaky(x: torch.Tensor, alpha: float = TORCH_ALPHA) -> torch.Tensor:
    return F.leaky_relu(x, alpha)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is where it is wider (float64): where flax
    computes "in float32" it promotes to at least float32."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _check_flavor(flavor: str) -> None:
    if flavor not in FLAVORS:
        raise ValueError(f"arch_flavor={flavor!r}; expected one of {FLAVORS}")


def conv_same_pads(k: int, dilation: int = 1) -> tuple[int, int]:
    """(low, high) padding of a stride-1 ``"SAME"`` conv, flax's rule."""
    total = dilation * (k - 1)
    return total // 2, total - total // 2


def same_pads(size: int, k: int, stride: int = 1, dilation: int = 1) -> tuple[int, int]:
    """(low, high) padding of flax's ``"SAME"`` on an axis of ``size`` at
    any stride (``lax.padtype_to_pads``): ``ceil(size / stride)`` outputs,
    the odd pad high. At stride 2 it depends on the size (a 7x7 conv on 192
    rows pads (2, 3), a 3x3 max-pool on 96 pads (0, 1)); a conv and a
    max-pool take it alike."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def deconv_same_pads(k: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of the lhs-dilated input in flax's
    ``ConvTranspose(padding="SAME")`` (``lax._conv_transpose_padding``)."""
    pad_len = k + stride - 2
    low = k - 1 if stride > k - 1 else -(-pad_len // 2)
    return low, pad_len - low


class Conv(nn.Conv2d):
    """A stride-1 ``"SAME"`` conv; asymmetric pads (even kernels) go through
    ``F.pad``. Its input is cast to ``dtype``, as flax's ``nn.Conv(dtype=)``
    casts it, then :func:`conv` applies it."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        lo, hi = conv_same_pads(k, dilation)
        super().__init__(cin, cout, k, padding=lo if lo == hi else 0,
                         dilation=dilation, dtype=dtype)
        self.dtype = dtype
        self.pads = None if lo == hi else (lo, hi, lo, hi)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self, x.to(self.dtype))


class Deconv(nn.ConvTranspose2d):
    """A transposed conv whose input is padded (low, high) after
    lhs-dilation, as ``lax.conv_transpose`` pads it, with the flax kernel
    flipped in space (weights.py). ``ConvTranspose2d`` pads ``k - 1 - p``
    low and ``k - 1 - p + output_padding`` high; pads it cannot express
    (fewer high than low, as flax's SAME at stride 2) take
    ``padding = k - 1 - low`` and drop ``crop`` rows and columns at the
    bottom/right of its output."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 pads: tuple[int, int], dtype: torch.dtype = torch.float32):
        lo, hi = k - 1 - pads[0], k - 1 - pads[1]  # crops of the full output
        if 0 <= lo - hi < stride:
            padding, output_padding, crop = lo, lo - hi, 0
        elif hi > lo:
            padding, output_padding, crop = lo, 0, hi - lo
        else:
            raise ValueError(f"transposed-conv pads {pads} at kernel {k}, stride {stride}")
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         output_padding=output_padding, dtype=dtype)
        self.dtype = dtype
        self.crop = crop

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self, x.to(self.dtype))


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=)``: the input cast to ``dtype``, the weight
    and bias to the input's dtype where they are applied."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, bias=bias, dtype=dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


def conv(layer: nn.Conv2d | nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` with the weight and bias cast to ``x``'s dtype (a no-op
    where they have it already) and the layer's explicit pads or crop."""
    w = layer.weight.to(x.dtype)
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    if isinstance(layer, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x, w, b, layer.stride, layer.padding,
                               layer.output_padding, layer.groups,
                               layer.dilation)
        crop = getattr(layer, "crop", 0)
        return y[..., : y.shape[-2] - crop, : y.shape[-1] - crop] if crop else y
    pads = getattr(layer, "pads", None)
    if pads is not None:
        x = F.pad(x, pads)
    return F.conv2d(x, w, b, layer.stride, layer.padding, layer.dilation,
                    layer.groups)


def drop(
    x: torch.Tensor, rate: float, generator: torch.Generator | None
) -> torch.Tensor:
    """flax ``nn.Dropout``: ``x * (u < keep) / keep`` with u uniform from
    ``generator`` (on ``x``'s device); rate 0 returns ``x``, rate 1 zeros.
    ``F.dropout`` takes no generator, so it is not used."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("a training-mode forward with dropout needs a generator")
    keep = 1.0 - rate
    u = draws.rand(tuple(x.shape), generator, x.device)
    return x * (u < keep) / keep


class StackedLayers(nn.Module):
    """``depth`` layers of one architecture whose parameters are stacked on
    a leading axis: the module's tree is ``layer``'s, each parameter (depth,
    *shape), as flax's ``vmap`` of ``init`` stacks them. ``layer`` itself
    is kept as the template (not a child) that :meth:`apply_layer` runs
    with one layer's slice."""

    def __init__(self, layer: nn.Module, depth: int):
        super().__init__()
        self.depth = int(depth)
        object.__setattr__(self, "layer", layer)
        stacked = copy.deepcopy(layer)
        for m in stacked.modules():
            for name, p in list(m._parameters.items()):
                if p is not None:
                    m._parameters[name] = nn.Parameter(p.new_empty((self.depth, *p.shape)))
        for name, child in stacked.named_children():
            self.add_module(name, child)

    def apply_layer(self, stacked: dict[str, torch.Tensor], i: int,
                    *args, **kwargs) -> torch.Tensor:
        """The template applied with layer ``i`` of ``stacked`` (name ->
        (depth, ...) tensor, names relative to this module)."""
        from torch.func import functional_call

        return functional_call(self.layer, {k: v[i] for k, v in stacked.items()},
                               args, kwargs)


def _pool(x: torch.Tensor) -> torch.Tensor:
    # flax max_pool(2, 2, SAME) == ceil_mode for odd sizes
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


class EncoderAtrous(nn.Module):
    """Dilated-conv encoder. torch flavour: /4 downsample, 3 stages of 3
    convs at filters, 2x, 4x (pytorch/CNNs.py:73-88). tf flavour:
    /2**num_blocks, ``num_blocks`` stages at filters * 2**b, a bottleneck at
    filters * 2**num_blocks (tensorflow/Network.py:416-447). Dropout
    ``dropout`` after each stage in training mode."""

    def __init__(
        self, in_channels: int, filters: int = 64, kernel_size: int = 3,
        dilation: int = 2, flavor: str = "torch",
        dtype: torch.dtype = torch.float32, dropout: float = 0.5,
        num_blocks: int = 2,
    ):
        super().__init__()
        _check_flavor(flavor)
        self.flavor = flavor
        self.dropout = dropout
        self.num_blocks = num_blocks

        def add(name: str, cin: int, cout: int) -> None:
            self.add_module(name, Conv(cin, cout, kernel_size, dilation, dtype))

        chans = in_channels
        if flavor == "torch":
            for stage, mult in enumerate((1, 2, 4)):
                f = filters * mult
                for i in range(3):
                    add(f"conv{3 * stage + i + 1}", chans if i == 0 else f, f)
                chans = f
        else:
            for block in range(num_blocks):
                f = filters * 2**block
                for i in range(3):
                    add(f"block{block}_conv{i + 1}", chans if i == 0 else f, f)
                chans = f
            f = filters * 2**num_blocks
            for i in range(3):
                add(f"bottleneck_conv{i + 1}", chans if i == 0 else f, f)
            chans = f
        self.out_channels = chans

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        if self.flavor == "torch":
            for stage in range(3):
                c1, c2, c3 = (getattr(self, f"conv{3 * stage + i}") for i in (1, 2, 3))
                x1 = leaky(c1(x))
                x2 = leaky(c2(x1)) + x1
                x3 = leaky(c3(x2)) + x2
                if stage < 2:
                    x3 = leaky(_pool(x3))
                x = drop(x3, rate, generator)
            return x
        for block in range(self.num_blocks):
            x = leaky(getattr(self, f"block{block}_conv1")(x), TF_ALPHA)
            x = leaky(getattr(self, f"block{block}_conv2")(x), TF_ALPHA)
            x = getattr(self, f"block{block}_conv3")(x)  # linear
            x = drop(F.relu(_pool(x)), rate, generator)
        for i in range(3):
            x = leaky(getattr(self, f"bottleneck_conv{i + 1}")(x), TF_ALPHA)
        return drop(x, rate, generator)


class DecoderUp(nn.Module):
    """Transposed-conv decoder: (C, h, w) -> (out_channels, 2**n h, 2**n w).

    torch flavour (n = 2): deconv/2x -> two same-size deconvs with skips ->
    deconv/2x head, LeakyReLU(0.1) on every layer including the head
    (pytorch/CNNs.py:151-157). tf flavour (n = num_blocks): per block
    deconv/2x + 2 convs at filters * 2**b (LeakyReLU 0.01), a linear
    deconv/2x head (tensorflow/Network.py:449-474). ``in_channels`` is what
    flax reads from the input."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_size: int = 3,
        flavor: str = "torch", dtype: torch.dtype = torch.float32,
        filters: int = 64, num_blocks: int = 2,
    ):
        super().__init__()
        _check_flavor(flavor)
        self.flavor = flavor
        self.num_blocks = num_blocks
        k = kernel_size

        def up(cin: int, cout: int) -> Deconv:
            # torch: the reference's crop, padding=1, output_padding=1 for
            # any k (JAX pads (k - 2, k - 1)); tf: flax's SAME
            pads = (k - 2, k - 1) if flavor == "torch" else deconv_same_pads(k, 2)
            return Deconv(cin, cout, k, 2, pads, dtype)

        if flavor == "torch":
            half = in_channels // 2
            self.deconv1 = up(in_channels, half)
            self.deconv2 = Deconv(half, half, k, 1, deconv_same_pads(k, 1), dtype)
            self.deconv3 = Deconv(half, half, k, 1, deconv_same_pads(k, 1), dtype)
            self.deconv4 = up(half, out_channels)
            return
        chans = in_channels
        for block in range(num_blocks - 1, 0, -1):
            f = filters * 2**block
            self.add_module(f"block{block}_deconv", up(chans, f))
            self.add_module(f"block{block}_conv1", Conv(f, f, k, 1, dtype))
            self.add_module(f"block{block}_conv2", Conv(f, f, k, 1, dtype))
            chans = f
        self.head_deconv = up(chans, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.flavor == "torch":
            x1 = leaky(self.deconv1(x))
            x2 = leaky(self.deconv2(x1)) + x1
            x3 = leaky(self.deconv3(x2)) + x2
            return leaky(self.deconv4(x3))
        for block in range(self.num_blocks - 1, 0, -1):
            x = leaky(getattr(self, f"block{block}_deconv")(x), TF_ALPHA)
            x = leaky(getattr(self, f"block{block}_conv1")(x), TF_ALPHA)
            x = leaky(getattr(self, f"block{block}_conv2")(x), TF_ALPHA)
        return self.head_deconv(x)  # linear output head
