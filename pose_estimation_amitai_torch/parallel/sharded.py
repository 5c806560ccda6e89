"""The data-parallel train step (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/parallel/sharded.py``. JAX
replicates the state over a mesh, shards each batch's rows over ``data``
and lets GSPMD all-reduce the gradients; here each process holds the
state, takes its rows of the batch (:func:`shard_microbatches`), runs the
port's microbatch forward and backward (train/loop.py) and all-reduces the
gradient tree over the ``data`` group before the one Adam update, so every
process applies the same update. ``torch.nn.parallel.DistributedDataParallel``
hooks a module's ``forward``; the port's step is a function of a
``TrainState`` that calls ``functional_call``, so the all-reduce is the
step's own.

What GSPMD gives JAX for free, the step does explicitly:

* BatchNorm's batch moments are the whole batch's: the means of x and x^2
  are all-reduced over ``data`` (differentiably) before the variance is
  formed (models/norm.py ``replica_moments``), so the running averages
  agree on every process and with one process on the whole batch. This is
  not ``torch.nn.SyncBatchNorm``, whose momentum and unbiased running
  variance are not flax's;
* the random draws are the whole batch's: augmentation, mask re-dilation
  and dropout draw over every row of the microbatch from the one
  (seed, step, microbatch) generator and keep this process's rows
  (ops/draws.py). The rank is never folded into the seed, so an N-process
  step trains on what the 1-process step trains on, and a resume is exact
  across world sizes.

On a ``(data, model)`` mesh the state holds column shards (parallel/
tensor.py); the step gathers them before the forward and updates only its
shard.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from ..config import Config
from ..models.norm import replica_moments
from ..ops.draws import row_share
from ..train.loop import TrainState, _microbatch_fn, adam_update, step_generator
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_index,
    axis_size,
    data_rows,
    psum,
    shard_params,
)


def shard_state(mesh, state: TrainState) -> TrainState:
    """The state replicated over the mesh: every tensor (parameters, Adam
    state, running averages) broadcast from the mesh's first process."""
    return state.replace(params=shard_params(mesh, state.params),
                         opt_state=shard_params(mesh, state.opt_state),
                         batch_stats=shard_params(mesh, state.batch_stats))


def shard_microbatches(mesh, batch: dict) -> dict:
    """An (accum, B, ...) batch dict -> this process's rows of B, sharded
    over ``data``; tensors of fewer than 2 dims as they are."""
    return {k: v[:, data_rows(mesh, v.shape[1])] if v.ndim >= 2 else v
            for k, v in batch.items()}


def all_reduce_mean(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """The mean of each tensor over ``group``, in one flat all-reduce."""
    n = dist.get_world_size(group)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= n
    return [f.view_as(t).to(t.dtype) for f, t in zip(flat.split([t.numel() for t in tensors]),
                                                    tensors)]


def make_sharded_train_step(model: nn.Module, cfg: Config, mesh) -> Callable:
    """``step(state, batch, lr_scale) -> (state, loss)``: one Adam update
    over ``accum`` microbatches, data-parallel over ``mesh``.

    ``batch``: this process's rows of (accum, B, ...) tensors on the device
    (:func:`shard_microbatches`): ``image``, ``confmaps``, and where the
    dataset has them ``peaks`` / ``peak_vals`` (augmentation re-renders the
    targets at the moved peaks) and the cameras ``P`` / ``P_inv``. Without
    augmentation the stored maps are the targets, as in JAX's sharded step.
    The gradients are averaged over the microbatches and over ``data``, the
    loss (a device scalar) too; the running averages are the last
    microbatch's, the same on every process."""
    group = mesh.get_group(DATA_AXIS)
    dp, rank = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)
    expand = None
    if axis_size(mesh, MODEL_AXIS) > 1:
        from .tensor import gather_params, param_specs

        specs = param_specs(mesh, model)

        def expand(params: dict) -> dict:
            return gather_params(mesh, specs, params)

    micro = _microbatch_fn(model, cfg, stored_targets=True, expand=expand)

    def mean_over_data(t: torch.Tensor) -> torch.Tensor:
        return psum(t, group) / dp

    def step(state: TrainState, batch: dict, lr_scale: float = 1.0):
        device = batch["image"].device
        accum = batch["image"].shape[0]
        rows = torch.arange(batch["image"].shape[1], device=device)
        loss_sum, grad_sum = None, None
        stats = state.batch_stats
        for i in range(accum):
            data = {("box" if k == "image" else k): v[i] for k, v in batch.items()}
            gen = step_generator(state.seed, state.step, i, device)
            with row_share(rank, dp), replica_moments(mean_over_data):
                loss, g, stats = micro(state.params, stats, data, rows, gen)
            if grad_sum is None:
                loss_sum, grad_sum = loss, g
            else:
                loss_sum = loss_sum + loss
                grad_sum = {k: grad_sum[k] + g[k] for k in grad_sum}
        names = list(grad_sum)
        reduced = all_reduce_mean([grad_sum[k] / accum for k in names] + [loss_sum / accum],
                                  group)
        params, opt_state = adam_update(cfg, state, dict(zip(names, reduced[:-1])), lr_scale)
        new_state = TrainState(step=state.step + 1, params=params, opt_state=opt_state,
                               seed=state.seed, batch_stats=stats)
        return new_state, reduced[-1]

    return step
