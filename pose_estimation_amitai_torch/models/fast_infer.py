"""Inference fast path: ``BasicNet`` through the fused Hopper kernels.

Counterpart of ``pose_estimation_amitai_tpu/models/fast_infer.py``: the
flagship torch-flavour ``BasicNet`` forward as three fused encoder stages
(ops/hopper_conv.py) and one fused decoder (ops/hopper_deconv.py), on the
same flax params. On CUDA tensors that is five kernel runs; on CPU tensors
the plain versions of the same arithmetic. Inference only.

Two JAX-side workarounds are not ported: the batch <= 8 ``lax.map``
chunking (a Mosaic layout crash) and the latent in {128, 256} gate (a Mosaic
lane limit) — the port's decoder kernel takes any latent width.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..ops import custom_ops
from .layers import TORCH_ALPHA


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
    for k, p in enumerate(kparams["stages"]):
        h = custom_ops.fused_encoder_stage(
            h, p["w1"], p["b1"], p["w2"], p["b2"], p["w3"], p["b3"],
            dilation, TORCH_ALPHA, k < 2)
    d = kparams["decoder"]
    return custom_ops.fused_decoder(
        h, d["w1"], d["b1"], d["w2"], d["b2"], d["w3"], d["b3"], d["w4"], d["b4"],
        TORCH_ALPHA).float()
