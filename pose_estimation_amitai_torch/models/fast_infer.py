"""Inference fast path: ``BasicNet`` through the fused Hopper kernels.

Counterpart of ``pose_estimation_amitai_tpu/models/fast_infer.py``: the
flagship torch-flavour ``BasicNet`` forward as three fused encoder stages
(ops/hopper_conv.py) and one fused decoder (ops/hopper_deconv.py), on the
same flax params. On CUDA tensors that is five kernel runs; on CPU tensors
the plain versions of the same arithmetic. Inference only.

The 4-camera disentanglement model (``FourCamDisentangled``, the same
encoder and decoder shared by its views) runs the same kernels on its
views folded into the batch, one view-row a view, with its middle as one
op (ops/ftl_fusion.py) between them: B1 three times, ``ftl_fusion`` once,
B2 once a chunk.

Two JAX-side workarounds are not ported: the batch <= 8 ``lax.map``
chunking (a Mosaic layout crash) and the latent in {128, 256} gate (a Mosaic
lane limit) — the port's decoder kernel takes any latent width.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..ops import custom_ops
from ..tracing import span
from .disentangled import NUM_CAMS
from .layers import TORCH_ALPHA
from .norm import EPSILON


def encoder_stage_params(params: Mapping) -> list[dict]:
    """flax BasicNet params -> per-stage HWIO weight dicts for the kernel.

    The torch-flavour encoder names its convs conv1..conv9, three per stage.
    """
    enc = params["encoder"]
    return [
        {
            f"{p}{i}": enc[f"conv{3 * k + i}"][name]
            for i in (1, 2, 3)
            for p, name in (("w", "kernel"), ("b", "bias"))
        }
        for k in range(3)
    ]


def decoder_params(params: Mapping) -> dict:
    """flax BasicNet params -> the decoder kernel's w1..w4 / b1..b4 (flax
    ConvTranspose HWIO kernels, used as they are)."""
    dec = params["decoder"]
    return {
        f"{p}{i}": dec[f"deconv{i}"][name]
        for i in (1, 2, 3, 4)
        for p, name in (("w", "kernel"), ("b", "bias"))
    }


def kernel_params(
    params: Mapping, dtype: torch.dtype, device: torch.device | str
) -> dict:
    """The fused route's kernel arguments, made once: weights in ``dtype``,
    biases float32, all contiguous on ``device``.

    Returns ``{"stages": [3 dicts], "decoder": dict}``."""

    def tensor(name: str, v) -> torch.Tensor:
        t = torch.as_tensor(np.array(v, np.float32), device=device)
        return (t if name.startswith("b") else t.to(dtype)).contiguous()

    return {
        "stages": [{n: tensor(n, v) for n, v in s.items()}
                   for s in encoder_stage_params(params)],
        "decoder": {n: tensor(n, v) for n, v in decoder_params(params).items()},
    }


def basicnet_apply_fused(
    kparams: dict, x: torch.Tensor, *, dilation: int = 2
) -> torch.Tensor:
    """Forward a torch-flavour 3x3 ``BasicNet`` through the fused kernels:
    NHWC frames -> (B, H, W, K) float32 maps.

    ``kparams`` comes from :func:`kernel_params`; the convs run in its
    weights' dtype. Equals ``BasicNet(...)(x)`` on the same params. Each
    stage and the decoder are one custom op (ops/custom_ops.py), so an
    exported program keeps the kernels."""
    h = x.to(kparams["stages"][0]["w1"].dtype).contiguous()
    return _decode(kparams, _encode(kparams, h, dilation))


def _encode(kparams: dict, h: torch.Tensor, dilation: int) -> torch.Tensor:
    """The three fused encoder stages on NHWC ``h`` in the weights' dtype."""
    for k, p in enumerate(kparams["stages"]):
        h = custom_ops.fused_encoder_stage(
            h, p["w1"], p["b1"], p["w2"], p["b2"], p["w3"], p["b3"],
            dilation, TORCH_ALPHA, k < 2)
    return h


def _decode(kparams: dict, h: torch.Tensor) -> torch.Tensor:
    """The fused decoder on the latent ``h``: float32 maps."""
    d = kparams["decoder"]
    return custom_ops.fused_decoder(
        h, d["w1"], d["b1"], d["w2"], d["b2"], d["w3"], d["b3"], d["w4"], d["b4"],
        TORCH_ALPHA).float()


FTL_1X1 = ("rearrange1", "fusion1", "fusion2", "rearrange2")
FTL_BN = ("bn1", "bn2", "bn3")


def disentangled_kernel_params(
    params: Mapping, batch_stats: Mapping, dtype: torch.dtype, device: torch.device | str
) -> dict:
    """flax ``FourCamDisentangled`` params and ``batch_stats`` -> the fused
    route's arguments, made once: ``"stages"`` and ``"decoder"`` from its
    shared encoder and decoder by :func:`kernel_params`'s bridge, and
    ``"ftl"``, the arguments of ``ftl_fusion`` after the cameras: each 1x1
    as a (Cin, Cout) matrix and its bias in ``dtype``, each BatchNorm as a
    (4, C) float32 stack of scale, bias, running mean and variance."""
    shared = kernel_params({"encoder": params["shared_encoder"],
                            "decoder": params["shared_decoder"]}, dtype, device)

    def tensor(v, dt: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.array(v, np.float32), device=device).to(dt).contiguous()

    ftl: list = []
    for name in FTL_1X1:
        k = np.asarray(params[name]["kernel"])
        ftl += [tensor(k.reshape(k.shape[-2:]), dtype), tensor(params[name]["bias"], dtype)]
    for name in FTL_BN:
        p, s = params[name], batch_stats[name]
        ftl.append(tensor(np.stack([p["scale"], p["bias"], s["mean"], s["var"]]),
                          torch.float32))
    return {**shared, "ftl": ftl}


def disentangled_apply_fused(
    kparams: dict, x: torch.Tensor, P: torch.Tensor, P_inv: torch.Tensor, *,
    dilation: int = 2,
) -> torch.Tensor:
    """Forward a torch-flavour 3x3 ``FourCamDisentangled`` through the fused
    kernels: (B, H, W, 4 Cc) NHWC frames, the four views' channels side by
    side, and per-sample cameras P (B, 4, 3, 4), P_inv (B, 4, 4, 3) -> (4B,
    H, W, K / 4) float32 maps, one view-row a view, sample-major (row 4b +
    v: channels v K/4 .. (v + 1) K/4 of the module's (B, H, W, K)).

    ``kparams`` comes from :func:`disentangled_kernel_params`. The frames
    are cast to the weights' dtype and split into view-rows in one copy;
    the maps are left as the decoder writes them."""
    b, h, w, c = x.shape
    v, cc = NUM_CAMS, c // NUM_CAMS
    rows = torch.empty((b, v, h, w, cc), dtype=kparams["stages"][0]["w1"].dtype, device=x.device)
    rows.copy_(x.view(b, h, w, v, cc).permute(0, 3, 1, 2, 4))
    lat = _encode(kparams, rows.view(b * v, h, w, cc), dilation)
    with span("pe.ftl"):
        lat = custom_ops.ftl_fusion(lat, P, P_inv, *kparams["ftl"], EPSILON)
    return _decode(kparams, lat)
