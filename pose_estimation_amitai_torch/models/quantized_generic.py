"""Generic calibrated-int8 serving for every model family (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/models/quantized_generic.py``:
every ``nn.Linear``, ``nn.Conv2d`` and ``nn.ConvTranspose2d`` of a model
(flax's ``nn.Dense``, ``nn.Conv``, ``nn.ConvTranspose``), the subclasses
that pad as flax does included (models/layers.py ``Conv``, ``Deconv``,
``Dense``; models/resnet.py ``PadConv``; the ViT's ``PatchConv``), runs as
an int8 x int8 product with a dequantising epilogue, and everything else
(LayerNorm, BatchNorm on its running averages, softmax, the FTL geometry,
the cubic resize, min-max normalisation, flax ``DenseGeneral``, which is no
``nn.Dense``) runs in float as the float model runs it.

Scheme (as models/quantized.py and JAX): a symmetric per-tensor activation
scale, the input's amax / 127 over the calibration batches (floored at
1e-12); symmetric per-output-channel weight scales over flax's last kernel
axis, which is dim 0 of a ``Linear`` (out, in) or ``Conv2d`` (O, I, kh, kw)
weight and dim 1 of a ``ConvTranspose2d`` (I, O, kh, kw) weight. The
activation is quantised as JAX's ``_quant_tensor`` does it: cast to bf16,
times ``bf16(float32(1 / scale))`` rounded to bf16, to float32, rounded
half to even and clipped to +-127.

Each quantised layer runs its own forward, so its own padding, cropping and
layout, on the quantised activation and weight as integer-valued float64
tensors with the bias left off. Those sums are exact (|sum| <= 127**2 * K,
K <= 3 * 3 * 2048, far below 2**53), so they equal JAX's int32
accumulators; the epilogue is then JAX's: ``acc * (float32(s_x) * s_w) +
bias`` in float32, cast to the layer's dtype.

Layers are selected by module type and named by their flax path (the
module's ``state_dict`` prefix with "/" for "."), so the scales compare with
JAX's one to one. A ``layer_filter(path, module)`` narrows the selection:
:func:`conv_layers_only` is JAX's ViT mixed-precision mode.
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .vit import PatchConv

_QUANT_TYPES = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)
CALIBRATION_CHUNK = 8  # frames a calibration batch, as JAX splits them
CALIBRATION_FRAMES = 32  # at most

LayerFilter = Callable[[str, nn.Module], bool]


def conv_layers_only(path: str, module: nn.Module) -> bool:
    """``layer_filter``: quantise the convs and transposed convs, keep the
    ``Linear`` layers (the transformer trunk) in float. The ViT's patch
    embedding is excluded by its ``patch_embed`` path, as JAX excludes it:
    it feeds every token of the float trunk."""
    if not isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
        return False
    return "patch_embed" not in path.split("/")


def quantizable_layers(
    model: nn.Module, layer_filter: LayerFilter | None = None
) -> dict[str, nn.Module]:
    """``{flax path: module}`` of the layers JAX's interceptor rewrites,
    narrowed by ``layer_filter``."""
    out = {}
    for name, m in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(m, _QUANT_TYPES) and (layer_filter is None or layer_filter(path, m)):
            out[path] = m
    return out


def _channel_axis(layer: nn.Module) -> int:
    """The output-channel axis of ``layer``'s output: last for a ``Linear``
    and the patch conv (tokens out), 1 for an NCHW conv."""
    return -1 if isinstance(layer, (nn.Linear, PatchConv)) else 1


def _quant_tensor(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """JAX's ``_quant_tensor`` as an integer-valued float64 tensor: ``x`` to
    bf16, times the bf16 ``inv``, to float32, rounded half to even,
    clipped to +-127."""
    q = torch.round((x.to(torch.bfloat16) * inv).float()).clamp_(-127, 127)
    return q.double()


def weight_scales(weight: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """float32 per-output-channel scales max|w| / 127, floored at 1e-12.
    The divisor is a tensor: a scalar divisor may be taken as a multiply
    by its reciprocal, which rounds otherwise."""
    axis = 1 if isinstance(layer, nn.ConvTranspose2d) else 0
    dims = [d for d in range(weight.ndim) if d != axis]
    amax = weight.float().abs().amax(dim=dims)
    return torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)


class QuantizedLayer(nn.Module):
    """One layer's int8 forward: the quantised input through ``int_layer``,
    a float64 copy of the layer holding the integer weights and no bias,
    then the float32 epilogue, cast to the layer's dtype.

    The scales and integer weights are made once on the host and moved to
    the layer's device: CUDA's ``tensor / scalar`` multiplies by the
    reciprocal, which is not JAX's correctly rounded division, and one ulp
    of a scale changes the epilogue's bits (seen on the H100: 12 of 37
    layers of the full-width ViT off the CPU's)."""

    def __init__(self, layer: nn.Module, weight: torch.Tensor,
                 bias: torch.Tensor | None, act_scale: float):
        super().__init__()
        self.dtype = layer.dtype
        self.axis = _channel_axis(layer)
        device = weight.device
        w = weight.detach().float().cpu()
        s_w = weight_scales(w, layer)
        shape = [1] * w.ndim
        shape[1 if isinstance(layer, nn.ConvTranspose2d) else 0] = -1
        w_q = torch.clamp(torch.round(w / s_w.view(shape)), -127, 127)
        s_x = torch.tensor(act_scale, dtype=torch.float32)
        self.register_buffer("inv", (1.0 / s_x).to(torch.bfloat16).to(device))
        self.register_buffer("out_scale", (s_x * s_w).to(device))
        self.register_buffer("bias", None if bias is None else bias.float())
        self.int_layer = layer
        layer.weight = nn.Parameter(w_q.double().to(device), requires_grad=False)
        layer.register_parameter("bias", None)
        layer.dtype = torch.float64

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = self.int_layer(_quant_tensor(x, self.inv))
        shape = [1] * acc.ndim
        shape[self.axis] = -1
        y = acc.float() * self.out_scale.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        return y.to(self.dtype)


def _device(params: dict[str, torch.Tensor]) -> torch.device:
    return next(iter(params.values())).device


def calibrate_apply(
    model: nn.Module,
    params: dict[str, torch.Tensor],
    sample_inputs: Sequence[tuple],
    layer_filter: LayerFilter | None = None,
) -> dict[str, float]:
    """Per-layer input amax / 127 over the calibration batches, keyed by
    flax path.

    ``model``: a materialised module (its forward runs on ``params``'
    device); ``params``: its ``state_dict`` (parameters and buffers,
    float32), applied through ``functional_call`` in eval mode, so a bf16
    module computes as flax's ``dtype=bf16`` module on float32 parameters.
    ``sample_inputs``: positional-argument tuples of the forward.
    ``layer_filter`` restricts which layers are calibrated, and therefore
    quantised by :func:`make_quantized_apply`. Each scale is the float32
    value of max(amax / 127, 1e-12), as JAX computes it."""
    layers = quantizable_layers(model, layer_filter)
    amax: dict[str, torch.Tensor] = {}

    def hook_for(path: str) -> Callable:
        def hook(_module, args):
            a = args[0].detach().abs().amax().float()
            amax[path] = a if path not in amax else torch.maximum(amax[path], a)
        return hook

    handles = [m.register_forward_pre_hook(hook_for(p)) for p, m in layers.items()]
    collect: dict[str, float] = {}
    model.eval()
    try:
        with torch.no_grad():
            for inputs in sample_inputs:
                amax.clear()
                functional_call(model, params, tuple(inputs))
                for k, v in amax.items():
                    collect[k] = max(collect.get(k, 0.0), float(v))
    finally:
        for h in handles:
            h.remove()
    return {k: float(np.float32(max(v / 127.0, 1e-12))) for k, v in collect.items()}


def quantize_model(
    model: nn.Module, params: dict[str, torch.Tensor], act_scales: dict[str, float]
) -> nn.Module:
    """A copy of ``model`` in eval mode on ``params``' device with every
    layer named in ``act_scales`` swapped for its :class:`QuantizedLayer`.
    ``model`` gives the structure (it may live on the meta device) and is
    left as it was; ``params`` (its ``state_dict`` in float32) give the
    weights: the quantised layers take their scales and integer weights
    from them, the rest compute on them."""
    qmodel = copy.deepcopy(model).to_empty(device=_device(params)).eval()
    qmodel.load_state_dict(params)
    for path, scale in act_scales.items():
        name = path.replace("/", ".")
        parent_name, _, attr = name.rpartition(".")
        parent = qmodel.get_submodule(parent_name)
        setattr(parent, attr, QuantizedLayer(
            getattr(parent, attr), params[f"{name}.weight"], params.get(f"{name}.bias"),
            scale))
    return qmodel


def make_quantized_apply(
    model: nn.Module,
    params: dict[str, torch.Tensor],
    act_scales: dict[str, float],
    out_dtype: torch.dtype = torch.float32,
) -> Callable:
    """``fn(*inputs) -> output`` in ``out_dtype``: the eval forward of
    :func:`quantize_model`'s copy, every layer named in ``act_scales`` on
    int8."""
    qmodel = quantize_model(model, params, act_scales)

    def forward(*inputs: torch.Tensor):
        with torch.no_grad():
            return qmodel(*inputs).to(out_dtype)

    return forward


def calibration_batches(
    frames, cameras: tuple | None = None, *, device: torch.device | str
) -> list[tuple[torch.Tensor, ...]]:
    """JAX's calibration split: float32 chunks of 8 of the first 32 frames
    (of the first min(32, frames, camera rows) samples with their ``(P,
    P_inv)`` rows for a camera model), on ``device``."""
    frames = np.asarray(frames, np.float32)
    n = min(len(frames), CALIBRATION_FRAMES)
    arrays = [frames]
    if cameras is not None:
        arrays += [np.asarray(c, np.float32) for c in cameras]
        n = min(n, *(len(c) for c in cameras))
    return [tuple(torch.from_numpy(a[i: min(i + CALIBRATION_CHUNK, n)]).to(device)
                  for a in arrays)
            for i in range(0, n, CALIBRATION_CHUNK)]


def quantize_predict_fn(
    model: nn.Module,
    params: dict[str, torch.Tensor],
    calibration_inputs,
    out_dtype: torch.dtype = torch.float32,
    layer_filter: LayerFilter | None = None,
) -> Callable:
    """Calibrate and build in one step. ``calibration_inputs``: a list of
    positional-argument tuples, or one frames array, split by
    :func:`calibration_batches`."""
    if not isinstance(calibration_inputs, list):
        calibration_inputs = calibration_batches(calibration_inputs, device=_device(params))
    scales = calibrate_apply(model, params, calibration_inputs, layer_filter)
    return make_quantized_apply(model, params, scales, out_dtype)
