"""Pipeline parallelism (GPipe schedule) over the ViT trunk (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/parallel/pipeline.py``: the
ViT heatmap model (models/vit.py ``ViTPoseNet``: patch embedding, L pre-LN
blocks, final LayerNorm, CNN decoder) with its L blocks' parameters stacked
on a leading axis (models/layers.py ``StackedLayers``) and split over the
mesh's ``pipe`` axis, each stage holding L / S consecutive blocks; the
embedding, final norm and decoder replicate.

The schedule is JAX's ``_trunk_shardmapped``: M + S - 1 ticks, at tick t
stage k runs its blocks on microbatch t - k and passes the result one hop
along the ring to stage k + 1 (the last tick without the hop); stage 0
takes microbatch t from the token stream. The last stage's outputs are then
summed over ``pipe``, so every stage holds them and computes the same loss
from them.

JAX differentiates the SPMD program as a whole. Here each stage is its own
process, and autograd runs a backward node only where a gradient reaches
it: a hop whose received value a stage does not use would never run its
backward there, and its neighbour would wait for it. So the trunk is one
``torch.autograd.Function`` whose backward is the reversed schedule, tick
by tick, in the same order on every stage: the cotangent of each tick's
output comes back along the reversed ring and the stage recomputes that
tick's blocks from the input it kept (GPipe's re-materialisation) to pass
the cotangent of its input on. Bubble ticks (no microbatch at this stage)
compute nothing and pass zeros.

Gradient scale: the sum of the last stage's outputs over ``pipe`` passes
the cotangent back as it is (``psum_replicated``), since every stage
computes the same loss; summing the S equal cotangents would make the
trunk's and the replicated modules' gradients S times too large. The token
stream enters through ``share_input``: stage 0 alone consumes it, and the
all-reduce of its cotangent gives every stage the embedding's whole
gradient. The gradients then equal :meth:`PipelinedViT.apply_sequential`'s.

Dropout in the trunk is 0, as in JAX (the reference ViTs train without).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.autograd import Function
from torch.func import functional_call

from ..models.layers import StackedLayers, at_least_f32
from ..models.vit import LN_EPS, Attention, CNNDecoderViT, FeedForward, PatchEmbed
from ..train.loop import TrainState, _init_params, adam_step
from .mesh import (
    DATA_AXIS,
    _ring_hop,
    all_gather,
    axis_index,
    axis_size,
    make_2d_mesh,
    psum_replicated,
    share_input,
    shard_params,
)
from .sharded import all_reduce_mean
from .tensor import map_state

PIPE_AXIS = "pipe"
PARTS = ("embed", "blocks", "final_norm", "decoder")


class PipelineBlock(nn.Module):
    """One pre-LN transformer block, attention then MLP, each with its
    residual: one step of models/vit.py ``Transformer`` (torch flavour,
    dropout 0)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 mlp_dim: int = 1024, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.attn = Attention(dim, heads, dim_head, dtype)
        self.ff = FeedForward(dim, mlp_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attn(x) + x
        return self.ff(x) + x


def make_pipeline_mesh(dp: int, pp: int, device: torch.device | str = "cuda"):
    """A ``(data, pipe)`` mesh: data parallelism over rows, the pipeline
    ring over columns."""
    return make_2d_mesh(dp, pp, PIPE_AXIS, device)


def _part(params: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


class _GPipe(Function):
    """The trunk over the ``pipe`` ring: ``(toks, *block tensors) ->``
    the last stage's outputs (M, mb, N, D), zeros on the other stages."""

    @staticmethod
    def forward(ctx, pipe: "PipelinedViT", names: list[str], toks, *blocks):
        stage, S, group = pipe.stage, pipe.stages, pipe.pipe_group
        M = toks.shape[0]
        local = dict(zip(names, blocks))
        inputs: dict[int, torch.Tensor] = {}
        outs = torch.zeros_like(toks)
        state = None
        for t in range(M + S - 1):
            mb = t - stage
            if 0 <= mb < M:
                x = toks[mb] if stage == 0 else state
                inputs[t] = x
                y = pipe._apply_local_blocks(local, x)
                if stage == S - 1:
                    outs[mb] = y
            else:
                y = torch.zeros_like(toks[0])
            if t < M + S - 2:
                state = _ring_hop(y, group, 1)
        ctx.pipe, ctx.names, ctx.inputs, ctx.shape = pipe, names, inputs, toks.shape
        ctx.save_for_backward(*blocks)
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        pipe, inputs = ctx.pipe, ctx.inputs
        stage, S, group = pipe.stage, pipe.stages, pipe.pipe_group
        blocks = [b.detach().requires_grad_() for b in ctx.saved_tensors]
        local = dict(zip(ctx.names, blocks))
        M = ctx.shape[0]
        g_toks = g_outs.new_zeros(ctx.shape)
        g_blocks = [torch.zeros_like(b) for b in blocks]
        g_send = None
        for t in reversed(range(M + S - 1)):
            # the cotangent of this tick's output: from the stage it went to
            g_y = (_ring_hop(g_send, group, -1) if t < M + S - 2
                   else g_outs.new_zeros(ctx.shape[1:]))
            mb = t - stage
            if not 0 <= mb < M:
                g_send = g_outs.new_zeros(ctx.shape[1:])
                continue
            if stage == S - 1:
                g_y = g_outs[mb]
            with torch.enable_grad():
                x = inputs[t].detach().requires_grad_()
                y = pipe._apply_local_blocks(local, x)
                g = torch.autograd.grad(y, [x, *blocks], g_y.to(y.dtype), allow_unused=True)
            for acc, gb in zip(g_blocks, g[1:]):
                if gb is not None:
                    acc += gb
            if stage == 0:
                g_toks[mb] = g[0]
                g_send = g_outs.new_zeros(ctx.shape[1:])
            else:
                g_send = g[0]
        return (None, None, g_toks, *g_blocks)


class PipelinedViT:
    """The ViT heatmap model with its trunk pipelined over ``pipe``.

    Parameters are one flat dict (``state_dict`` names): ``embed.*``
    (``PatchEmbed``), ``blocks.*`` (a :class:`PipelineBlock` tree, each
    tensor (depth, ...), or (depth / S, ...) on a stage after
    :meth:`shard_params`), ``final_norm.*`` and ``decoder.*``
    (``CNNDecoderViT``). ``apply`` takes this process's rows of the batch
    (the data axis is the caller's: parallel/sharded.py) and returns their
    maps on every stage."""

    def __init__(
        self, mesh, *, image_hw: int = 192, in_channels: int = 4,
        out_channels: int = 18, patch_size: int = 16, dim: int = 256,
        depth: int = 8, heads: int = 8, dim_head: int = 64, mlp_expand: int = 4,
        kernel_size: int = 3, num_microbatches: int | None = None,
        flavor: str = "torch", dtype: torch.dtype = torch.bfloat16,
    ):
        self.mesh = mesh
        self.stages = axis_size(mesh, PIPE_AXIS)
        self.stage = axis_index(mesh, PIPE_AXIS)
        self.pipe_group = mesh.get_group(PIPE_AXIS)
        if depth % self.stages:
            raise ValueError(f"depth {depth} must divide into {self.stages} pipeline stages")
        M = self.stages if num_microbatches is None else int(num_microbatches)
        if M < 1:
            raise ValueError(f"num_microbatches must be >= 1, got {M}")
        # the stages are pre-LN blocks, the torch flavour's trunk; the tf
        # flavour's post-LN blocks are not staged (plain ViTPoseNet serves it)
        if flavor != "torch":
            raise ValueError(f"pipeline parallelism supports the torch ViT flavour, got {flavor!r}")
        self.num_microbatches = M
        self.depth = depth
        self.image_hw, self.in_channels, self.out_channels = image_hw, in_channels, out_channels
        self.dim = dim
        self.tokens = (image_hw // patch_size) ** 2
        self.dtype = dtype
        with torch.device("meta"):
            self.parts = nn.ModuleDict({
                "embed": PatchEmbed(in_channels, self.tokens, dim, patch_size,
                                    post_norm=True, dtype=dtype),
                "blocks": StackedLayers(
                    PipelineBlock(dim, heads, dim_head, dim * mlp_expand, dtype), depth),
                "final_norm": nn.LayerNorm(dim, eps=LN_EPS, dtype=torch.float32),
                "decoder": CNNDecoderViT(out_channels, dim, kernel_size, flavor, dtype),
            })

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """Parameters drawn by flax's initialisers (train/loop.py), each
        block's in turn and stacked, seeded from ``generator``; float32 on
        the generator's device."""
        seed = int(torch.randint(2**62, (), generator=generator, device=generator.device))
        params = _init_params(self.parts, np.random.default_rng(seed))
        return {k: v.to(generator.device) for k, v in params.items()}

    def shard_params(self, params: dict) -> dict:
        """The first process's parameters on every process, then this
        stage's depth / S blocks of the stacks."""
        params = shard_params(self.mesh, params)
        per = self.depth // self.stages
        return {k: v[self.stage * per : (self.stage + 1) * per] if k.startswith("blocks.") else v
                for k, v in params.items()}

    def gather_blocks(self, params: dict) -> dict:
        """The whole stacks from each stage's (differentiable)."""
        return {k: all_gather(v, self.pipe_group, 0) if k.startswith("blocks.") else v
                for k, v in params.items()}

    # -------------------------------------------------------------- forward
    def _apply_local_blocks(self, blocks: dict, x: torch.Tensor) -> torch.Tensor:
        stack = self.parts["blocks"]
        for i in range(next(iter(blocks.values())).shape[0]):
            x = stack.apply_layer(blocks, i, x)
        return x

    def _head(self, params: dict, y: torch.Tensor) -> torch.Tensor:
        y = functional_call(self.parts["final_norm"], _part(params, "final_norm"),
                            (at_least_f32(y),))
        return functional_call(self.parts["decoder"], _part(params, "decoder"), (y,))

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """embed -> the pipelined trunk -> final LayerNorm -> decoder: (B,
        H, W, C) frames, B divisible by ``num_microbatches`` -> (B, H, W,
        K) maps on every stage."""
        M, b = self.num_microbatches, x.shape[0]
        if b % M:
            raise ValueError(f"batch {b} must divide into {M} microbatches")
        tokens = functional_call(self.parts["embed"], _part(params, "embed"), (x,))
        toks = share_input(tokens.reshape(M, b // M, self.tokens, self.dim), self.pipe_group)
        blocks = _part(params, "blocks")
        names = list(blocks)
        outs = _GPipe.apply(self, names, toks, *(blocks[k] for k in names))
        y = psum_replicated(outs, self.pipe_group)
        return self._head(params, y.reshape(b, self.tokens, self.dim))

    def apply_sequential(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """The same function without the pipeline: the whole stacks (as
        :meth:`init` gives them) applied in turn on one process."""
        tokens = functional_call(self.parts["embed"], _part(params, "embed"), (x,))
        return self._head(params, self._apply_local_blocks(_part(params, "blocks"), tokens))


def pipeline_params_to_vit(params):
    """Parameters in the pipeline's layout -> ``ViTPoseNet``'s: the port's
    ``state_dict`` names (``embed.*`` -> ``patch_embed.*``, ``blocks.X`` row
    i -> ``transformer.attn{i}`` / ``ff{i}``, ``final_norm`` ->
    ``transformer.final_norm``), or on a flax tree the JAX function's
    rearrangement (weights.py)."""
    from .. import weights

    if "blocks" in params and "embed" in params:
        return weights.pipeline_tree_to_vit(params)
    return weights.pipeline_state_dict_to_vit(params)


def vit_params_to_pipeline(params, depth: int):
    """The inverse of :func:`pipeline_params_to_vit`, on either layout."""
    from .. import weights

    if "transformer" in params:
        return weights.vit_tree_to_pipeline(params, depth)
    return weights.vit_state_dict_to_pipeline(params, depth)


class PipelinedViTFlax(nn.Module):
    """:class:`PipelinedViT` as the ``nn.Module`` the generic machinery
    drives (train/loop.py ``create_train_state``, ``make_eval_step``,
    parallel/sharded.py): its parameters are the pipeline's, with
    ``blocks.*`` holding this stage's stacks after :func:`shard_state_pp`.
    A batch whose rows do not divide into ``num_microbatches`` (the
    trailing validation batch) runs :meth:`PipelinedViT.apply_sequential`
    on the stacks gathered from every stage, the same function. Dropout is
    0 in the trunk, so ``generator`` is taken and not used."""

    def __init__(self, pipe: PipelinedViT):
        super().__init__()
        object.__setattr__(self, "pipe", pipe)
        for name in PARTS:
            self.add_module(name, pipe.parts[name])

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        params = dict(self.named_parameters())
        if x.shape[0] % self.pipe.num_microbatches == 0:
            return self.pipe.apply(params, x)
        return self.pipe.apply_sequential(self.pipe.gather_blocks(params), x)


def shard_state_pp(mesh, state: TrainState, model: nn.Module) -> TrainState:
    """The state for (data, pipe) training: replicated from the mesh's first
    process, then this stage's rows of each ``blocks.*`` stack and of its
    Adam moments; the rest replicates."""
    from .sharded import shard_state

    state = shard_state(mesh, state)
    S, k = axis_size(mesh, PIPE_AXIS), axis_index(mesh, PIPE_AXIS)

    def rows(name: str, t: torch.Tensor) -> torch.Tensor:
        if not name.startswith("blocks."):
            return t
        per = t.shape[0] // S
        return t[k * per : (k + 1) * per].contiguous()

    return map_state(state, model, rows)


def gather_state_pp(mesh, state: TrainState, model: nn.Module) -> TrainState:
    """The whole state on every process from :func:`shard_state_pp`'s rows
    (for a checkpoint)."""
    group = mesh.get_group(PIPE_AXIS)

    def whole(name: str, t: torch.Tensor) -> torch.Tensor:
        if not name.startswith("blocks."):
            return t
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts)

    return map_state(state, model, whole)


def make_pipelined_train_step(model: PipelinedViT, learning_rate: float = 1e-3):
    """``(init, step)``: ``init(params) -> opt_state`` (a fresh Adam state)
    and ``step(params, opt_state, batch) -> (params, opt_state, loss)``, one
    Adam update at ``learning_rate`` of the MSE of ``model.apply`` on
    ``batch`` (this process's rows of ``image`` and ``confmaps``). Each
    stage updates its own blocks; every gradient and the loss are averaged
    over ``data``."""
    group = model.mesh.get_group(DATA_AXIS)

    def init(params: dict) -> dict:
        return torch.optim.Adam(list(params.values()), lr=learning_rate).state_dict()

    def step(params: dict, opt_state: dict, batch: dict):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        pred = model.apply(live, batch["image"])
        loss = torch.mean(torch.square(pred.float() - batch["confmaps"]))
        names = list(live)
        grads = torch.autograd.grad(loss, [live[k] for k in names])
        reduced = all_reduce_mean([*grads, loss.detach()], group)
        new, opt_state = adam_step(params, opt_state, dict(zip(names, reduced[:-1])),
                                   learning_rate)
        return new, opt_state, reduced[-1]

    return init, step
