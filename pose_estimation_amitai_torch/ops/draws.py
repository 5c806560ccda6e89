"""Random draws of a batch as one share of the whole batch's draws.

Every random draw of the train step (augmentation, mask re-dilation,
dropout) takes one value, or one slab of values, per row of the batch, from
the microbatch's generator (train/loop.py). Under data parallelism each
process holds ``1 / count`` of the rows; inside :func:`row_share` a draw
takes the values of the whole batch, ``count`` times the rows, and keeps
this process's ``index``-th block of them. The generator then advances as
it does on one process, and each row gets the draw it gets there, so an
N-process step trains on what the 1-process step trains on (JAX's sharded
step draws over the global batch too). Outside a share, the draws are
``torch.rand`` / ``torch.randint`` as they are. A draw of one value for
the whole batch (the augmentation's canvas bucket) is the same in and out
of a share: :func:`scalar_randint`.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch

_SHARE: contextvars.ContextVar[tuple[int, int] | None] = contextvars.ContextVar(
    "row_share", default=None)


@contextlib.contextmanager
def row_share(index: int, count: int) -> Iterator[None]:
    """Inside, draws over ``b`` rows are rows ``[index * b, (index + 1) *
    b)`` of the draw over ``count * b`` rows."""
    token = _SHARE.set((int(index), int(count)))
    try:
        yield
    finally:
        _SHARE.reset(token)


def _rows(draw, shape: tuple[int, ...]) -> torch.Tensor:
    share = _SHARE.get()
    if share is None:
        return draw(tuple(shape))
    index, count = share
    rows = shape[0]
    return draw((rows * count, *shape[1:]))[index * rows : (index + 1) * rows]


def rand(shape: tuple[int, ...], generator: torch.Generator,
         device: torch.device | str) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator``, as this share's rows."""
    return _rows(lambda s: torch.rand(s, generator=generator, device=device), shape)


def randint(high: int, shape: tuple[int, ...], generator: torch.Generator,
            device: torch.device | str) -> torch.Tensor:
    """``torch.randint(0, high, shape)`` from ``generator``, as this share's
    rows."""
    return _rows(
        lambda s: torch.randint(0, high, s, generator=generator, device=device), shape)


def scalar_randint(high: int, generator: torch.Generator,
                   device: torch.device | str) -> int:
    """One ``torch.randint(0, high, ())`` from ``generator``: a value for
    the whole batch, the same in every share (a row share does not touch
    it)."""
    return int(torch.randint(0, high, (), generator=generator, device=device))
