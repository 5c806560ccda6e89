"""Tensor parallelism: column shards of the weights over a ``model`` axis
(PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/parallel/tensor.py``. On a
``(data, model)`` mesh every parameter of 2 dims or more whose output
features (flax's trailing kernel axis) divide by the ``model`` extent is
split over ``model`` (Megatron's column split), its Adam moments with it;
the rest replicate. The step (parallel/sharded.py) all-gathers the whole
weight before the forward, so the math is the replicated step's, and
updates only its own shard: each process keeps ``1 / mp`` of those
weights and of their optimiser state between steps.

The output-feature axis is read from the module that holds the weight, as
the weight bridge reads it (weights.py): dim 0 of a ``Linear`` or
``Conv2d`` weight, dim 1 of a ``ConvTranspose2d`` weight, the last dim of
a weight the port keeps in flax's layout (``DenseGeneral``, the ViT's
positional embedding).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from ..train.loop import TrainState, frozen_names
from .mesh import MODEL_AXIS, all_gather, axis_index, axis_size


def _feature_dim(module: nn.Module, name: str, ndim: int) -> int:
    if isinstance(module, nn.ConvTranspose2d) and name == "weight":
        return 1
    if isinstance(module, (nn.Linear, nn.Conv2d)) and name == "weight":
        return 0
    return ndim - 1


def param_spec(mesh, model: nn.Module, name: str) -> int | None:
    """The dim of parameter ``name`` of ``model`` split over ``model``, or
    None where it replicates (fewer than 2 dims, or output features that
    do not divide)."""
    mp = axis_size(mesh, MODEL_AXIS)
    shape = model.get_parameter(name).shape
    if len(shape) < 2:
        return None
    owner, _, leaf = name.rpartition(".")
    dim = _feature_dim(model.get_submodule(owner), leaf, len(shape))
    return dim if shape[dim] % mp == 0 and shape[dim] >= mp else None


def param_specs(mesh, model: nn.Module) -> dict[str, int | None]:
    """:func:`param_spec` of every parameter of ``model``."""
    return {name: param_spec(mesh, model, name) for name, _ in model.named_parameters()}


def map_state(state: TrainState, model: nn.Module,
              fn: Callable[[str, torch.Tensor], torch.Tensor]) -> TrainState:
    """``state`` with ``fn(name, tensor)`` applied to each parameter and to
    its Adam moments (``exp_avg``, ``exp_avg_sq``); the rest as it is."""
    frozen = frozen_names(model, state.params)
    trained = [k for k in state.params if k not in frozen]
    params = {k: fn(k, v) for k, v in state.params.items()}
    moments = {
        i: {m: fn(trained[i], v) if m in ("exp_avg", "exp_avg_sq") else v
            for m, v in s.items()}
        for i, s in state.opt_state["state"].items()}
    return state.replace(params=params, opt_state={**state.opt_state, "state": moments})


def shard_state_tp(mesh, state: TrainState, model: nn.Module) -> TrainState:
    """The state for (data, model) training: replicated from the mesh's
    first process (parallel/sharded.py ``shard_state``), then this
    process's block of each split parameter and of its Adam moments. A
    mesh without a ``model`` axis (or of extent 1) replicates only."""
    from .sharded import shard_state

    state = shard_state(mesh, state)
    mp = axis_size(mesh, MODEL_AXIS)
    if mp == 1:
        return state
    specs, i = param_specs(mesh, model), axis_index(mesh, MODEL_AXIS)

    def block(name: str, t: torch.Tensor) -> torch.Tensor:
        dim = specs[name]
        if dim is None:
            return t
        n = t.shape[dim] // mp
        return t.narrow(dim, i * n, n).contiguous()

    return map_state(state, model, block)


def gather_params(mesh, specs: dict[str, int | None], params: dict) -> dict:
    """The whole parameters from this process's blocks (differentiable:
    the gradient of a block is its part of the whole weight's)."""
    group = mesh.get_group(MODEL_AXIS)
    return {k: v if specs.get(k) is None else all_gather(v, group, specs[k])
            for k, v in params.items()}


def gather_state_tp(mesh, state: TrainState, model: nn.Module) -> TrainState:
    """The whole state on every process from the blocks of
    :func:`shard_state_tp` (for a checkpoint)."""
    if axis_size(mesh, MODEL_AXIS) == 1:
        return state
    specs, group = param_specs(mesh, model), mesh.get_group(MODEL_AXIS)

    def whole(name: str, t: torch.Tensor) -> torch.Tensor:
        if specs[name] is None:
            return t
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=specs[name])

    return map_state(state, model, whole)
