"""Process groups, device meshes and the differentiable collectives
(PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/parallel/mesh.py``. JAX runs
one program over a mesh of devices and derives the collectives from
sharding annotations; PyTorch runs one process per device (``torchrun
--nproc_per_node N``), and the port calls the collectives itself:

* :func:`maybe_initialize_distributed` joins the process group that
  torchrun's environment describes (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``), with NCCL for a
  ``cuda`` device and gloo for the CPU, chosen by the device the caller
  names (:func:`backend_for`);
* :func:`make_mesh` / :func:`make_2d_mesh` build a
  ``torch.distributed.device_mesh.DeviceMesh`` over every process of the
  group, its dimensions named with JAX's axis names (``data``, ``model``,
  ``pipe``, ``seq``, ``expert``). There is no topology search
  (``_device_grid``): on one node every pair of cards is one NVLink hop
  apart, so ranks are laid out in order;
* :func:`shard_batch` keeps this process's rows of the ``data`` axis,
  :func:`shard_params` broadcasts from the mesh's first process;
* the differentiable collectives, each a ``torch.autograd.Function`` with
  the transpose JAX gives its ``shard_map`` counterpart: :func:`ppermute`
  (one hop along a ring; backward, the reversed ring), :func:`psum` (an
  all-reduce whose backward all-reduces the cotangents: each process's loss
  is its own, as for BatchNorm's moments over the ``data`` group),
  :func:`psum_replicated` (an all-reduce after which every process of the
  group computes the same loss: backward, the cotangent as it is, which is
  what ``lax.psum`` under an unmapped ``out_specs`` gives),
  :func:`share_input` (the identity on an input the group holds alike and
  uses in different parts: backward, the all-reduce of the cotangents, as
  ``shard_map`` transposes an unmapped input) and :func:`all_gather`
  (backward, this process's block of the cotangent, which every process of
  the group computed alike).

At degree 1 a collective still runs on its one-process group (NCCL on the
card), except the ring hop, which is the identity there as ``lax.ppermute``
over a ring of one is.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import torch
import torch.distributed as dist
from torch.autograd import Function

DATA_AXIS = "data"
MODEL_AXIS = "model"


def backend_for(device: torch.device | str) -> str:
    """The process-group backend of ``device``: NCCL on ``cuda``, gloo
    elsewhere."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize_distributed(cfg=None, *, device: torch.device | str = "cuda") -> bool:
    """Join the process group torchrun's environment describes, where one is
    configured; True when the group has more than one process.

    A no-op returning False when neither ``cfg.distributed`` is set nor
    ``WORLD_SIZE`` is in the environment. Already initialised: the group's
    size decides. Otherwise ``init_process_group(backend_for(device),
    "env://")`` (on ``cuda``, the process's card is ``LOCAL_RANK``); if
    that fails, ``RuntimeError`` when ``cfg.distributed`` asked for it (a
    silent single-process run would let every process train alone), and
    one printed line and False when only the environment asked."""
    asked = bool(getattr(cfg, "distributed", False))
    if not (asked or "WORLD_SIZE" in os.environ):
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    device = torch.device(device)
    try:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend_for(device), init_method="env://")
    except (RuntimeError, ValueError) as e:
        if asked:
            raise RuntimeError(
                f"Config.distributed was set but init_process_group failed: {e}") from e
        print(f"init_process_group skipped: {e}", flush=True)
        return False
    return dist.get_world_size() > 1


def _device_mesh(device: torch.device | str, shape: tuple[int, ...],
                 names: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a process group: run under torchrun or call "
            "torch.distributed.init_process_group first")
    n, world = 1, dist.get_world_size()
    for s in shape:
        n *= int(s)
    if n != world:
        raise ValueError(
            f"a {tuple(shape)} mesh needs {n} processes, the group has {world}")
    return init_device_mesh(torch.device(device).type, tuple(int(s) for s in shape),
                            mesh_dim_names=names)


def make_mesh(mesh_shape: tuple[int, ...] = (), device: torch.device | str = "cuda"):
    """A ``(data[, model])`` mesh over every process: ``()`` is a 1-D data
    mesh of the group's size, ``(dp,)`` or ``(dp, mp)`` explicit extents
    whose product is the group's size."""
    shape = tuple(mesh_shape) or (dist.get_world_size() if dist.is_initialized() else 1,)
    return _device_mesh(device, shape, (DATA_AXIS, MODEL_AXIS)[: len(shape)])


def make_2d_mesh(dp: int, n: int, second_axis: str,
                 device: torch.device | str = "cuda"):
    """A ``(data, second_axis)`` mesh: data parallelism over rows, the ring
    of ``second_axis`` over columns."""
    return _device_mesh(device, (dp, n), (DATA_AXIS, second_axis))


def axis_size(mesh, axis: str) -> int:
    """The extent of ``axis`` in ``mesh`` (1 where the mesh has no such
    axis, or there is no mesh)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh, axis: str) -> int:
    """This process's coordinate along ``axis`` (``lax.axis_index``)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return int(mesh.get_local_rank(axis))


def data_rows(mesh, rows: int) -> slice:
    """This process's contiguous rows of ``rows`` sharded over ``data``."""
    n = axis_size(mesh, DATA_AXIS)
    if rows % n:
        raise ValueError(f"{rows} rows do not divide over the {n}-way data axis")
    i, per = axis_index(mesh, DATA_AXIS), rows // n
    return slice(i * per, (i + 1) * per)


def _map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def shard_batch(mesh, batch):
    """A tree of (B, ...) tensors -> this process's rows of B, sharded over
    the ``data`` axis."""
    return _map(lambda x: x[data_rows(mesh, x.shape[0])], batch)


def broadcast(t: torch.Tensor, device: torch.device | str) -> torch.Tensor:
    """A copy of the first process's ``t`` on every process; a tensor held
    elsewhere than the group's device type (Adam's step counters on the
    host) travels through it."""
    device = torch.device(device)
    buf = t.detach().to(device, copy=True)
    dist.broadcast(buf, src=0)
    return buf.to(t.device)


def shard_params(mesh, params):
    """A tree of tensors replicated over the mesh: every process gets the
    first process's values."""
    return _map(lambda t: broadcast(t, mesh.device_type), params)


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------
def _ring_hop(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if shift % n == 0:
        return x.clone()
    r = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    to = dist.get_global_rank(group, (r + shift) % n)
    frm = dist.get_global_rank(group, (r - shift) % n)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to, group),
                                       dist.P2POp(dist.irecv, out, frm, group)]):
        req.wait()
    return out


class _PPermute(Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ring_hop(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ring_hop(g, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Each process's ``x`` to the process ``shift`` further along the
    group's ring, its predecessor's in return (``lax.ppermute`` over the
    ring ``i -> i + shift``); backward sends the cotangents back along the
    reversed ring."""
    return _PPermute.apply(x, group, shift)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _PSum(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _PSumReplicated(Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ShareInput(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group. Backward all-reduces the
    cotangents: the transpose where each process's loss is its own."""
    return _PSum.apply(x, group)


def psum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, after which every process of the
    group computes the same loss: backward passes the cotangent on as it
    is (summing the group's equal cotangents would count the loss once for
    each process)."""
    return _PSumReplicated.apply(x, group)


def share_input(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, which every process of the group holds alike and uses in a
    different part of the computation: backward sums the cotangents over
    the group, so each process holds the whole gradient of ``x``."""
    return _ShareInput.apply(x, group)


class _AllGather(Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.rank, ctx.dim, ctx.block = dist.get_rank(group), dim, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.block, ctx.block), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim``, in rank
    order. Every process of the group then computes the same loss, so each
    holds the whole cotangent: backward keeps this process's block of it."""
    return _AllGather.apply(x, group, dim)
