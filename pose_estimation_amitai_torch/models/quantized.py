"""Calibrated int8 inference for the flagship CNN (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/models/quantized.py``. Scheme:
symmetric per-tensor activation scales (amax over calibration frames / 127)
and per-output-channel weight scales; every conv and deconv multiplies
int8 x int8 into int32 exactly, then dequantises (``acc * s_x * s_w + bias``)
and applies LeakyReLU in float32. Structure mirrors the torch-flavour
``BasicNet`` (models/layers.py; reference pytorch/CNNs.py:73-157).

Three forwards share the scales and the weights of :func:`quantize_params`:

* :func:`make_quantized_forward` keeps bf16 activations between layers and
  quantises in each conv's prologue;
* :func:`make_quantized_resident_forward` stores int8 between layers (skips
  read the stored int8 dequantised by its own scale; the 2x2 max-pool runs
  on int8);
* :func:`make_quantized_fused_forward` runs each encoder stage through
  ``ops/hopper_qconv.fused_quantized_stage`` (the hand-written kernel on
  CUDA tensors), called as a custom op (ops/custom_ops.py), and the decoder
  on the pre-quantised latent.

The decoder's and the first two forwards' int8 products go to the library's
convolution in float64, which is exact (ops/int8_conv.py). Every requant is
``int8(clip(rint(bf16(x) * bf16(1 / s_x)), -127, 127))``, ties to even.
Each ``make_*`` returns ``fn(frames) -> maps`` on NHWC tensors of ``device``.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import custom_ops
from ..ops.hopper_conv import lrelu
from ..ops.hopper_qconv import dequant, pack_qconv_weights, quant_bf16
from ..ops.int8_conv import conv_s32, deconv_s1_s32, deconv_s2_s32, max_pool_2x2
from .layers import TORCH_ALPHA

BF16 = torch.bfloat16
_DEC = ("deconv1", "deconv2", "deconv3", "deconv4")


def _leaky(v: torch.Tensor) -> torch.Tensor:
    return lrelu(v, TORCH_ALPHA)


def _leaky_bf16(v: torch.Tensor) -> torch.Tensor:
    """LeakyReLU of a bf16 tensor with the slope rounded to bf16, as a
    bf16 ``x * alpha`` is evaluated in JAX."""
    slope = torch.tensor(TORCH_ALPHA, dtype=torch.float32, device=v.device).to(BF16)
    return torch.where(v >= 0, v, v * slope)


def _stage_names(s: int) -> tuple[str, str, str, str]:
    """The three convs of encoder stage ``s`` and the layer that follows."""
    n1, n2, n3 = (f"conv{3 * s + k + 1}" for k in range(3))
    return n1, n2, n3, (f"conv{3 * s + 4}" if s < 2 else "deconv1")


def _f32_conv(x: torch.Tensor, kernel, dilation: int = 1) -> torch.Tensor:
    w = torch.as_tensor(np.asarray(kernel, np.float32), device=x.device)
    pad = dilation * (w.shape[0] - 1) // 2
    return F.conv2d(x, w.permute(3, 2, 0, 1), padding=pad, dilation=dilation)


def _f32_deconv_s2(x: torch.Tensor, kernel) -> torch.Tensor:
    w = torch.as_tensor(np.asarray(kernel, np.float32), device=x.device)
    wt = torch.flip(w, (0, 1)).permute(2, 3, 0, 1)
    return F.conv_transpose2d(x, wt, stride=2, padding=1, output_padding=1)


def reference_forward(
    params: Mapping, x: torch.Tensor, collect: dict | None = None
) -> torch.Tensor:
    """Float32 forward of the torch-flavour ``BasicNet`` on a flax params
    tree: NHWC frames -> NHWC maps.

    Equals ``BasicNet`` on the bridged weights; optionally records each
    quantisable layer's input amax into ``collect`` for calibration.
    """
    enc, dec = params["encoder"], params["decoder"]

    def track(name: str, v: torch.Tensor) -> torch.Tensor:
        if collect is not None:
            collect[name] = max(collect.get(name, 0.0), float(v.abs().max()))
        return v

    def bias(layer) -> torch.Tensor:
        b = torch.as_tensor(np.asarray(layer["bias"], np.float32), device=x.device)
        return b[None, :, None, None]

    h = x.float().permute(0, 3, 1, 2)
    for s in range(3):
        c1, c2, c3 = (enc[n] for n in _stage_names(s)[:3])
        x1 = _leaky(_f32_conv(track(f"conv{3*s+1}", h), c1["kernel"], 2) + bias(c1))
        x2 = _leaky(_f32_conv(track(f"conv{3*s+2}", x1), c2["kernel"], 2)
                    + bias(c2)) + x1
        x3 = _leaky(_f32_conv(track(f"conv{3*s+3}", x2), c3["kernel"], 2)
                    + bias(c3)) + x2
        h = _leaky(F.max_pool2d(x3, 2, 2)) if s < 2 else x3

    d1, d2, d3, d4 = (dec[n] for n in _DEC)
    y1 = _leaky(_f32_deconv_s2(track("deconv1", h), d1["kernel"]) + bias(d1))
    y2 = _leaky(_f32_conv(track("deconv2", y1), d2["kernel"]) + bias(d2)) + y1
    y3 = _leaky(_f32_conv(track("deconv3", y2), d3["kernel"]) + bias(d3)) + y2
    y = _leaky(_f32_deconv_s2(track("deconv4", y3), d4["kernel"]) + bias(d4))
    return y.permute(0, 2, 3, 1)


def calibrate(
    params: Mapping, frames, batch: int = 32, *, device: torch.device | str
) -> dict[str, float]:
    """Per-layer input scales (amax / 127) over at most ``4 * batch``
    calibration frames, from float32 forwards on ``device``. On the card the
    library's convs run with TF32 off (it would round their inputs) and with
    deterministic algorithms: otherwise two calibrations on the same frames
    can differ in a scale's last bit, and two predictors built alike can
    then decode a near tie differently."""
    collect: dict[str, float] = {}
    cudnn = torch.backends.cudnn
    full_f32 = cudnn.flags(enabled=cudnn.enabled, benchmark=False,
                           deterministic=True, allow_tf32=False)
    with torch.inference_mode(), full_f32:
        for i in range(0, min(len(frames), 4 * batch), batch):
            chunk = torch.as_tensor(np.asarray(frames[i : i + batch], np.float32),
                                    device=device)
            reference_forward(params, chunk, collect)
    return {k: v / 127.0 for k, v in collect.items()}


def quantize_params(params: Mapping, act_scales: Mapping[str, float]) -> dict:
    """int8 weights and per-channel dequant multipliers, in numpy.

    For each layer of ``act_scales``: ``w_q`` int8 HWIO, ``bias`` float32,
    ``mult`` = s_x * s_w float32 per output channel, and ``s_x``."""
    enc, dec = params["encoder"], params["decoder"]
    q: dict[str, dict] = {}
    for name in list(act_scales):
        layer = enc[name] if name.startswith("conv") else dec[name]
        w = np.asarray(layer["kernel"], np.float32)
        s_w = np.abs(w).max(axis=(0, 1, 2)) / 127.0  # per out channel
        s_w = np.maximum(s_w, 1e-12)
        w_q = np.clip(np.round(w / s_w), -127, 127).astype(np.int8)
        # floor s_x like s_w: an all-zero calibration input (blank frames)
        # must not produce 1/0 when a forward is built
        s_x = max(float(act_scales[name]), 1e-12)
        q[name] = {
            "w_q": w_q,
            "bias": np.asarray(layer["bias"], np.float32),
            "mult": np.asarray(s_x * s_w, np.float32),
            "s_x": s_x,
        }
    return q


def device_layers(params, act_scales, device) -> tuple[dict, dict]:
    """``quantize_params`` as contiguous tensors on ``device`` (``w_q``,
    ``mult``, ``bias`` per layer; for the encoder's convs also ``w_packed``,
    the weights as the int8 conv kernels read them, packed here once), and
    each layer's input scale ``s_x`` as a Python float."""
    q = quantize_params(params, act_scales)
    layers = {
        n: {k: torch.as_tensor(v, device=device).contiguous()
            for k, v in layer.items() if k != "s_x"}
        for n, layer in q.items()
    }
    for n, layer in layers.items():
        if n.startswith("conv"):
            layer["w_packed"] = pack_qconv_weights(layer["w_q"])
    return layers, {n: q[n]["s_x"] for n in q}


def stage_args(layers: dict, s: int) -> list[torch.Tensor]:
    """``w1, m1, b1, w2, m2, b2, w3, m3, b3`` of encoder stage ``s`` (0-2),
    as ``fused_quantized_stage`` takes them, the weights packed, from
    :func:`device_layers`."""
    args = []
    for n in _stage_names(s)[:3]:
        args += [layers[n]["w_packed"], layers[n]["mult"], layers[n]["bias"]]
    return args


def _qconv_pre(layer: dict, x_q: torch.Tensor, conv_fn: Callable) -> torch.Tensor:
    """int8 conv of already-quantised ``x_q``, dequantised: float32 NHWC."""
    return dequant(conv_fn(x_q, layer["w_q"]), layer["mult"], layer["bias"])


def _conv_d2(x_q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return conv_s32(x_q, w, 2)


def make_quantized_forward(
    params: Mapping, act_scales: Mapping[str, float], *,
    device: torch.device | str, out_dtype: torch.dtype = torch.float32,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """int8 forward with bf16 activations between layers: dequant, bias and
    LeakyReLU in each conv's epilogue, the quant in the next one's prologue."""
    layers, s_x = device_layers(params, act_scales, device)
    inv = {n: 1.0 / v for n, v in s_x.items()}

    def qconv(name: str, x: torch.Tensor, conv_fn: Callable) -> torch.Tensor:
        return _qconv_pre(layers[name], quant_bf16(x, inv[name]), conv_fn)

    def forward(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            h = x.to(BF16)
            for s in range(3):
                n1, n2, n3, _ = _stage_names(s)
                x1 = _leaky(qconv(n1, h, _conv_d2)).to(BF16)
                x2 = _leaky(qconv(n2, x1, _conv_d2)).to(BF16) + x1
                x3 = _leaky(qconv(n3, x2, _conv_d2)).to(BF16) + x2
                h = _leaky_bf16(max_pool_2x2(x3)) if s < 2 else x3
            y1 = _leaky(qconv("deconv1", h, deconv_s2_s32)).to(BF16)
            y2 = _leaky(qconv("deconv2", y1, deconv_s1_s32)).to(BF16) + y1
            y3 = _leaky(qconv("deconv3", y2, deconv_s1_s32)).to(BF16) + y2
            return _leaky(qconv("deconv4", y3, deconv_s2_s32)).to(out_dtype)

    return forward


def make_quantized_resident_forward(
    params: Mapping, act_scales: Mapping[str, float], *,
    device: torch.device | str, out_dtype: torch.dtype = torch.bfloat16,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """int8-resident forward: every layer's output is requantised to the
    next layer's input scale, so the tensors stored between layers are
    int8. Residual adds read the stored int8 dequantised by its own scale,
    and the 2x2 max-pool runs on int8 (``quant(LReLU(.))`` is monotone, so
    pooling commutes with it)."""
    layers, s_x = device_layers(params, act_scales, device)
    inv = {n: 1.0 / v for n, v in s_x.items()}

    def qconv(name: str, x_q: torch.Tensor, conv_fn: Callable) -> torch.Tensor:
        return _qconv_pre(layers[name], x_q, conv_fn)

    def dq(name: str, x_q: torch.Tensor) -> torch.Tensor:
        """Stored int8 at ``name``'s scale -> float32 (for residual adds)."""
        return x_q.float() * s_x[name]

    def forward(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            h = quant_bf16(x.float(), inv["conv1"])
            for s in range(3):
                n1, n2, n3, nxt = _stage_names(s)
                q1 = quant_bf16(_leaky(qconv(n1, h, _conv_d2)), inv[n2])
                x2 = _leaky(qconv(n2, q1, _conv_d2)) + dq(n2, q1)
                q2 = quant_bf16(x2, inv[n3])
                x3 = _leaky(qconv(n3, q2, _conv_d2)) + dq(n3, q2)
                if s < 2:
                    h = max_pool_2x2(quant_bf16(_leaky(x3), inv[nxt]))
                else:
                    h = quant_bf16(x3, inv[nxt])
            y1 = _leaky(qconv("deconv1", h, deconv_s2_s32))
            q1 = quant_bf16(y1, inv["deconv2"])
            y2 = _leaky(qconv("deconv2", q1, deconv_s1_s32)) + dq("deconv2", q1)
            q2 = quant_bf16(y2, inv["deconv3"])
            y3 = _leaky(qconv("deconv3", q2, deconv_s1_s32)) + dq("deconv3", q2)
            q3 = quant_bf16(y3, inv["deconv4"])
            return _leaky(qconv("deconv4", q3, deconv_s2_s32)).to(out_dtype)

    return forward


def make_quantized_fused_forward(
    params: Mapping, act_scales: Mapping[str, float], *,
    device: torch.device | str, out_dtype: torch.dtype = torch.float32,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """int8 forward with fused encoder stages.

    Same arithmetic as :func:`make_quantized_forward` (scales, bf16 skips)
    with each encoder stage's requant chain inside
    ``fused_quantized_stage`` and only int8 between stages; the decoder
    runs the library int8 path on the pre-quantised latent."""
    layers, s_x = device_layers(params, act_scales, device)
    inv = {n: 1.0 / v for n, v in s_x.items()}

    def encoder_int8(x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) float -> int8 latent at deconv1's input scale."""
        h = quant_bf16(x, inv["conv1"]).contiguous()
        for s in range(3):
            _, n2, n3, nxt = _stage_names(s)
            h = custom_ops.fused_quantized_stage(
                h, *stage_args(layers, s), inv[n2], inv[n3], inv[nxt], 2,
                TORCH_ALPHA, s < 2)
            if s < 2:
                h = max_pool_2x2(h)
        return h

    def qconv(name: str, x: torch.Tensor, conv_fn: Callable) -> torch.Tensor:
        return _qconv_pre(layers[name], quant_bf16(x, inv[name]), conv_fn)

    def forward(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            lat = encoder_int8(x)
            y1 = _leaky(_qconv_pre(layers["deconv1"], lat, deconv_s2_s32)).to(BF16)
            y2 = _leaky(qconv("deconv2", y1, deconv_s1_s32)).to(BF16) + y1
            y3 = _leaky(qconv("deconv3", y2, deconv_s1_s32)).to(BF16) + y2
            return _leaky(qconv("deconv4", y3, deconv_s2_s32)).to(out_dtype)

    return forward
