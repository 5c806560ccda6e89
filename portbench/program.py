"""The system under test, reached only through the port's public entry
points: ``config.Config``, ``infer.Predictor`` (``__call__``,
``predict_movie``), ``data.pipeline.DeviceDataset``, ``weights``'s bridge and
``train.loop`` (``make_train_step``, ``TrainState``, ``create_optimizer``).
"""

from __future__ import annotations

import torch


def port_config(spec: dict, **overrides):
    from pose_estimation_amitai_torch.config import Config

    return Config(**{**spec["port_config"], **overrides})


def predictor(spec: dict, tree: dict, device: torch.device):
    """The port's ``Predictor`` of this configuration on its route, built
    from the flax-layout ``tree``."""
    from pose_estimation_amitai_torch.infer import Predictor

    pred = Predictor(
        port_config(spec), tree, tuple(spec["image_shape"]), spec["out_channels"],
        device=device, chunk_size=spec["chunk_size"],
        use_fused=spec["route"] == "fused", decode=spec["decode"])
    if pred.serving_path != spec["route"]:
        raise RuntimeError(f"asked for route {spec['route']!r}, the port serves "
                           f"{pred.serving_path!r}")
    return pred
