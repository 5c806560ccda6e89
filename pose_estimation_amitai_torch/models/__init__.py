"""Model registry of the PyTorch port: reference model-type strings ->
``nn.Module``.

Counterpart of ``pose_estimation_amitai_tpu/models/__init__.py``
``build_model``. This slice ports the BasicNet family only: the types the
JAX registry sends to ``BasicNet`` (its default branch,
tensorflow/Network.py:59-60) build the port's ``BasicNet``; every type the
JAX registry maps to another architecture raises ``NotImplementedError``
naming its ROADMAP item, never falling through to ``BasicNet``.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import constants as C
from ..config import Config
from .cnn import BasicNet

__all__ = ["BasicNet", "build_model"]

# model types the JAX registry maps to other architectures (JAX
# models/__init__.py build_model), with the architecture and ROADMAP item
_NOT_PORTED: dict[str, str] = {
    **{mt: "MultiCamNet (ROADMAP Queue A item 10)" for mt in (
        C.ALL_CAMS, C.ALL_CAMS_18_POINTS, C.ALL_CAMS_ALL_POINTS,
        C.HEAD_TAIL_ALL_CAMS, C.ALL_CAMS_AND_3_GOOD_CAMS)},
    C.TWO_WINGS_TOGATHER: "TwoWingsNet (ROADMAP Queue A item 10)",
    C.C2F_PER_WING: "C2FPerWing (ROADMAP Queue A item 10)",
    C.COARSE_PER_WING: "CoarsePerWing (ROADMAP Queue A item 10)",
    **{mt: "ViTPoseNet (ROADMAP Queue A item 10)" for mt in (
        C.MODEL_18_POINTS_PER_WING_VIT, C.ALL_POINTS_MODEL_VIT,
        C.MODEL_18_POINTS_3_GOOD_CAMERAS_VIT,
        C.MODEL_18_POINTS_PER_WING_VIT_TO_POINTS)},
    **{mt: "ViT4Cameras (ROADMAP Queue A item 10)" for mt in (
        C.ALL_CAMS_18_POINTS_VIT, C.ALL_CAMS_VIT, C.VIT_4_CAMERAS)},
    **{mt: "FourCamDisentangled (ROADMAP Queue A item 10)" for mt in (
        C.ALL_CAMS_DISENTANGLED_PER_WING_CNN,
        C.ALL_CAMS_DISENTANGLED_PER_WING_VIT)},
    C.RESNET_18_POINTS_PER_WING: "ResNetHeatmapNet (ROADMAP Queue A item 10)",
    C.GPTNET: "GPTResNet (ROADMAP Queue A item 10)",
}


def build_model(
    cfg: Config, image_size: tuple[int, ...], num_output_channels: int
) -> nn.Module:
    """Construct the model for ``cfg.model_type``.

    Args:
      cfg: typed config.
      image_size: (H, W, C) of the preprocessed input.
      num_output_channels: confmap channel count.
    """
    if cfg.model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"model type {cfg.model_type!r} builds "
            f"{_NOT_PORTED[cfg.model_type]}, not ported yet"
        )
    return BasicNet(
        in_channels=image_size[-1],
        out_channels=num_output_channels,
        filters=cfg.num_base_filters,
        kernel_size=cfg.kernel_size,
        dilation=cfg.dilation_rate,
        flavor=cfg.arch_flavor,
        dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32,
    )
