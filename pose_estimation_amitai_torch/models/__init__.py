"""Model registry of the PyTorch port: reference model-type strings ->
``nn.Module``.

Counterpart of ``pose_estimation_amitai_tpu/models/__init__.py``
``build_model``. The CNN family builds (models/cnn.py: ``BasicNet``, its
default branch, tensorflow/Network.py:59-60, ``CoarsePerWing``,
``C2FPerWing``, ``TwoWingsNet``; models/multicam.py: ``MultiCamNet``), as do
the four single-view ViT types (``ViTPoseNet``), the three 4-camera ViT
types (``ViT4Cameras``, models/vit.py), the ResNet families
(``ResNetHeatmapNet``, ``GPTResNet``, models/resnet.py) and the two
disentangled camera-matrix types (``FourCamDisentangled``,
models/disentangled.py): every architecture of the JAX registry.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from .. import constants as C
from ..config import Config
from .cnn import BasicNet, C2FPerWing, CoarsePerWing, TwoWingsNet
from .disentangled import FourCamDisentangled
from .multicam import LatentSelfAttention, MultiCamNet
from .resnet import GPTResNet, ResNetHeatmapNet
from .vit import ViT4Cameras, ViTPoseNet

__all__ = ["BasicNet", "CoarsePerWing", "C2FPerWing", "TwoWingsNet",
           "MultiCamNet", "LatentSelfAttention", "ViTPoseNet", "ViT4Cameras",
           "ResNetHeatmapNet", "GPTResNet", "FourCamDisentangled", "build_model",
           "vit_single_kwargs", "needs_camera_matrices", "augmentation_views",
           "layout_views", "layout_masks_per_view"]

_VIT_SINGLE = {
    C.MODEL_18_POINTS_PER_WING_VIT,
    C.ALL_POINTS_MODEL_VIT,
    C.MODEL_18_POINTS_3_GOOD_CAMERAS_VIT,
    C.MODEL_18_POINTS_PER_WING_VIT_TO_POINTS,
}
_VIT_4CAM = {C.ALL_CAMS_18_POINTS_VIT, C.ALL_CAMS_VIT, C.VIT_4_CAMERAS}
_MULTICAM_4 = {C.ALL_CAMS, C.ALL_CAMS_18_POINTS, C.ALL_CAMS_ALL_POINTS,
               C.HEAD_TAIL_ALL_CAMS}
_DISENTANGLED = {C.ALL_CAMS_DISENTANGLED_PER_WING_CNN,
                 C.ALL_CAMS_DISENTANGLED_PER_WING_VIT}


def needs_camera_matrices(model_type: str) -> bool:
    """True for models whose forward takes (x, P, P_inv)."""
    return model_type in _DISENTANGLED


def augmentation_views(model_type: str) -> int:
    """How many independent affine transforms a sample draws: one per
    camera-view channel block for ``ALL_CAMS_18_POINTS`` and its ViT twin
    (pytorch/Datagenerators.py:141-153) and for the disentangled
    camera-matrix models; one shared transform otherwise."""
    if model_type in {C.ALL_CAMS_18_POINTS, C.ALL_CAMS_18_POINTS_VIT}:
        return 4
    if model_type in _DISENTANGLED:
        return 4
    return 1


def layout_views(model_type: str) -> int:
    """Camera views stacked on the channel axis of this model's samples,
    which the mask-channel table of ``ops.morphology.random_mask_redilation``
    follows whatever the augmentation draws (tensorflow/
    simple_data_generator.py:104-111)."""
    if model_type == C.ALL_CAMS_AND_3_GOOD_CAMS:
        return 3
    if model_type in _MULTICAM_4 or model_type in _VIT_4CAM or (
        model_type in _DISENTANGLED
    ):
        return 4
    return 1


def layout_masks_per_view(model_type: str) -> int | None:
    """Wing-mask channels in each view block, or ``None`` to let
    ``random_mask_redilation`` infer them. ``BODY_PART_MODEL`` samples carry
    3 body-part masks that are never re-dilated: 0."""
    if model_type == C.BODY_PARTS_MODEL:
        return 0
    return None


def _dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _vit_arch_kwargs(cfg: Config, num_output_channels: int) -> dict[str, Any]:
    """Shared ViT architecture kwargs (single-view + 4-camera families).
    Dropout is not threaded: the reference ViT paths run with dropout 0.0
    (pytorch/VITs.py:197-229)."""
    # pytorch/VITs.py:212: dim_head = projection_dim if config["dim head"] else 64
    dim_head = cfg.projection_dim if cfg.dim_head else 64
    return dict(
        out_channels=num_output_channels,
        patch_size=cfg.patch_size,
        dim=cfg.projection_dim,
        depth=cfg.transformer_layers,
        heads=cfg.num_heads,
        dim_head=dim_head,
        mlp_expand=cfg.fully_connected_expand,
        kernel_size=cfg.kernel_size,
        dtype=_dtype(cfg),
    )


def vit_single_kwargs(cfg: Config, num_output_channels: int) -> dict[str, Any]:
    """ViT architecture kwargs for ``cfg`` (single-view heatmap family);
    raises for other model types, as the JAX function does."""
    if cfg.model_type not in _VIT_SINGLE:
        raise ValueError(
            f"pipeline_stages requires a single-view ViT model type, got "
            f"{cfg.model_type!r} (supported: {sorted(_VIT_SINGLE)})"
        )
    return dict(_vit_arch_kwargs(cfg, num_output_channels),
                flavor=cfg.arch_flavor)


def build_model(
    cfg: Config, image_size: tuple[int, ...], num_output_channels: int,
    **serving: Any,
) -> nn.Module:
    """Construct the model for ``cfg.model_type``.

    Args:
      cfg: typed config.
      image_size: (H, W, C) of the preprocessed input.
      num_output_channels: confmap channel count.
      serving: serving-only switches of the ViT families, set at
        construction where flax would ``clone``: ``normalize_output``,
        ``fast_softmax``, ``fused_serving``, ``fused_attention``,
        ``ref_token_grid`` (single-view), ``fold_views`` (4-camera ViT
        and ``MultiCamNet``). Any other for a CNN type raises
        ``TypeError``.
    """
    mt = cfg.model_type
    if mt in _VIT_SINGLE:
        return ViTPoseNet(
            image_size[-1], image_size[0],
            **vit_single_kwargs(cfg, num_output_channels), **serving)
    if mt in _VIT_4CAM:
        return ViT4Cameras(
            image_size[-1], image_size[0],
            **_vit_arch_kwargs(cfg, num_output_channels), **serving)
    cnn_kw: dict[str, Any] = dict(
        out_channels=num_output_channels,
        filters=cfg.num_base_filters,
        kernel_size=cfg.kernel_size,
        dilation=cfg.dilation_rate,
        dropout=cfg.dropout_ratio,
        num_blocks=cfg.num_blocks,
        flavor=cfg.arch_flavor,
        dtype=_dtype(cfg),
    )
    cin = image_size[-1]
    if mt in _MULTICAM_4 or mt == C.ALL_CAMS_AND_3_GOOD_CAMS:
        return MultiCamNet(cin, num_cams=layout_views(mt),
                           do_attention=cfg.do_attention, **cnn_kw, **serving)
    if serving:
        raise TypeError(f"a CNN model takes no serving switches, got {sorted(serving)}")
    if mt in _DISENTANGLED:
        return FourCamDisentangled(cin, **cnn_kw)
    if mt == C.RESNET_18_POINTS_PER_WING:
        return ResNetHeatmapNet(cin, num_output_channels, kernel_size=cfg.kernel_size,
                                flavor=cfg.resnet_flavor, dtype=_dtype(cfg))
    if mt == C.GPTNET:
        # pytorch/Network.py:15-26 routes GPTNET to the residual
        # encoder-decoder (NNs warehouse/NNs.py:70-136)
        return GPTResNet(cin, num_output_channels, dtype=_dtype(cfg))
    if mt == C.TWO_WINGS_TOGATHER:
        return TwoWingsNet(cin, **cnn_kw)
    if mt == C.C2F_PER_WING:
        # the frozen coarse stage regresses the same target set
        # (tensorflow/Network.py:169-198)
        return C2FPerWing(cin, coarse_out_channels=num_output_channels, **cnn_kw)
    if mt == C.COARSE_PER_WING:
        del cnn_kw["num_blocks"], cnn_kw["flavor"]
        return CoarsePerWing(cin, **cnn_kw)
    return BasicNet(cin, **cnn_kw)
