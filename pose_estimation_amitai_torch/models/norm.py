"""flax's ``nn.BatchNorm`` for the port's NCHW modules.

``torch.nn.BatchNorm2d`` is not flax's: flax keeps its running averages with
momentum 0.99 (torch's 0.01 counts the other way), updates the running
variance with the biased batch variance E[x^2] - E[x]^2 (clipped at 0),
leaves the averages as they are at ``init``, and normalises in float32
(at least) whatever the activations' dtype (the models give it ``dtype=float32``).
:class:`BatchNorm` computes exactly that: ``(x - mean) * (rsqrt(var + eps) *
scale) + bias`` in float32, in flax's order of operations.

Running averages are buffers, ``running_mean`` and ``running_var`` (flax's
``batch_stats`` ``mean`` and ``var``), float32 whatever the model's compute
dtype. A training-mode forward updates them by rebinding the buffers (never
in place), or, inside :func:`collect_batch_stats`, records the new values
in the collector and leaves the module as it was: that is how the train step
(train/loop.py) takes them out of a ``torch.func.functional_call`` as new
tensors. A module applied several times in one forward (the disentangled
model's ``bn3``, once per camera) updates from its own last value each time,
as flax's mutable collection does.

Under data parallelism the batch moments are the whole batch's: inside
:func:`replica_moments` the per-process means of x and x^2 pass through the
given reduction (parallel/sharded.py gives the mean over the ``data``
group, differentiable) before the variance is formed, as GSPMD reduces
them over the sharded batch axis in JAX. The running averages then agree on
every process, and with one process on the whole batch.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator

import torch
from torch import nn

from .layers import at_least_f32

MOMENTUM = 0.99  # flax nn.BatchNorm's default
EPSILON = 1e-5

_COLLECTOR: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "batch_stats_collector", default=None)
_REPLICA_MEAN: contextvars.ContextVar[Callable | None] = contextvars.ContextVar(
    "batch_norm_replica_mean", default=None)


@contextlib.contextmanager
def collect_batch_stats() -> Iterator[dict]:
    """Inside, training-mode :class:`BatchNorm` forwards record their new
    running averages in the dict yielded, ``{module: (mean, var)}``, the
    last value of each module, and change no module."""
    updates: dict = {}
    token = _COLLECTOR.set(updates)
    try:
        yield updates
    finally:
        _COLLECTOR.reset(token)


@contextlib.contextmanager
def replica_moments(mean_over_replicas: Callable[[torch.Tensor], torch.Tensor]) -> Iterator[None]:
    """Inside, training-mode :class:`BatchNorm` forwards take their batch
    moments through ``mean_over_replicas`` (a differentiable mean of a
    tensor over the processes that share the batch)."""
    token = _REPLICA_MEAN.set(mean_over_replicas)
    try:
        yield
    finally:
        _REPLICA_MEAN.reset(token)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(dtype=float32)`` over axis 1 of an NCHW tensor:
    float32 out. Parameters ``weight`` (flax ``scale``, ones) and ``bias``
    (zeros); buffers ``running_mean`` (zeros) and ``running_var`` (ones)."""

    def __init__(self, features: int, epsilon: float = EPSILON,
                 momentum: float = MOMENTUM):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = at_least_f32(x)
        if self.training:
            mean, sq = x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))
            if (over_replicas := _REPLICA_MEAN.get()) is not None:
                mean, sq = over_replicas(torch.stack([mean, sq]))
            var = torch.clamp(sq - mean * mean, min=0.0)
            self._update(mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None]
        return y + self.bias[:, None, None]

    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        updates = _COLLECTOR.get()
        ra_mean, ra_var = (updates.get(self) if updates is not None and self in updates
                           else (self.running_mean, self.running_var))
        m = self.momentum
        new = (m * ra_mean + (1 - m) * mean, m * ra_var + (1 - m) * var)
        if updates is not None:
            updates[self] = new
        else:
            self.running_mean, self.running_var = new
