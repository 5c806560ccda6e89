"""Weight bridge: flax variables <-> the port's ``state_dict``.

The flax side is a ``params`` tree (and, for the BatchNorm families, a
``batch_stats`` tree) as nested dicts of arrays (anything ``np.asarray``
takes), the layout the JAX package trains and checkpoints.

* :func:`flax_to_state_dict` — one walk for every ported model: the port's
  modules carry the flax tree's names, so each leaf is renamed and laid out
  by its kind. Conv kernels go HWIO -> OIHW. A flax ConvTranspose is a
  correlation of the lhs-dilated input with its kernel as it is; the port's
  layers are ``ConvTranspose2d``, which correlate with the kernel flipped in
  space, so flax kernels are flipped and laid out (I, O, kh, kw), and each
  layer pads as flax does (models/layers.py ``Deconv``). Which 4-D kernels
  are transposed convs is read from the model's module at that path where
  a model is given (GPTResNet's ``up1`` and ResNetHeatmapNet's ``head`` are
  transposed convs by another name), from a ``deconv`` in the path where
  none is. Dense kernels transpose, DenseGeneral kernels keep their layout,
  LayerNorm and BatchNorm ``scale`` becomes ``weight``; BatchNorm
  ``batch_stats`` ``mean`` / ``var`` become the buffers ``running_mean`` /
  ``running_var``.
* :func:`state_dict_to_flax` and :func:`batch_stats_to_flax` — the other
  way: the port's parameters (those the train step updates) -> the flax
  ``params`` tree, its running averages -> the ``batch_stats`` tree, as
  numpy, which ``Predictor``, :func:`kernel_params` and the JAX package
  take. :func:`basicnet_state_dict`, :func:`basicnet_params_from_state_dict`
  and :func:`vit_state_dict` are these under their earlier names.
* :func:`kernel_params` (models/fast_infer.py) — the fused kernels take the
  flax HWIO layout as it is.
* The pipeline's stacked-blocks ViT layout (parallel/pipeline.py, and the
  JAX package's) and ``ViTPoseNet``'s, both ways, on flax trees
  (:func:`pipeline_tree_to_vit`, :func:`vit_tree_to_pipeline`) and on the
  port's parameters (:func:`pipeline_state_dict_to_vit`,
  :func:`vit_state_dict_to_pipeline`), and a stacked flax tree to the
  port's pipelined parameters and back; the JAX package's MoE parameter
  dict to tensors and back (:func:`moe_params_to_torch`).

:func:`load_checkpoint` reads a checkpoint by what is on disk: the port's
``torch.save`` files (train/checkpoint.py) or the flax msgpack files of the
JAX package (:func:`load_flax_checkpoint`), decoded by this module's own
msgpack reader (:func:`unpack_flax_msgpack`; its inverse,
:func:`pack_flax_msgpack`, writes flax's bytes) with neither ``msgpack``
nor jax. :func:`init_basicnet_params` and
:func:`init_vit_params` make seeded flax-layout trees with numpy.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Mapping

import numpy as np
import torch

# flax msgpack ext type ids (flax/serialization.py _MsgpackExtType)
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def conv_kernel_to_torch(k_hwio: Any) -> torch.Tensor:
    """flax Conv kernel (kh, kw, I, O) -> torch Conv2d weight (O, I, kh, kw)."""
    k = np.asarray(k_hwio, np.float32)
    return torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy())


def deconv_kernel_to_torch(k_hwio: Any) -> torch.Tensor:
    """flax ConvTranspose kernel (kh, kw, I, O) -> torch ConvTranspose2d
    weight (I, O, kh, kw), flipped in space."""
    k = np.asarray(k_hwio, np.float32)[::-1, ::-1]
    # copy(): a flipped axis of length 1 keeps its negative stride through
    # ascontiguousarray, and torch.from_numpy refuses negative strides
    return torch.from_numpy(np.transpose(k, (2, 3, 0, 1)).copy())


def _bias(b: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(b, np.float32))


# flax batch_stats leaf -> the port's buffer, and back
STAT_BUFFERS = {"mean": "running_mean", "var": "running_var"}
_STAT_LEAVES = {v: k for k, v in STAT_BUFFERS.items()}


def is_stat(key: str) -> bool:
    """True for a ``state_dict`` key of a BatchNorm running average."""
    return key.rsplit(".", 1)[-1] in _STAT_LEAVES


def split_stats(sd: Mapping) -> tuple[dict, dict]:
    """A ``state_dict`` -> (its parameters, its running averages)."""
    return ({k: v for k, v in sd.items() if not is_stat(k)},
            {k: v for k, v in sd.items() if is_stat(k)})


def _transposed(path: str, model: torch.nn.Module | None) -> bool:
    """Whether the module at ``path`` is a transposed conv: its type in
    ``model`` where there is one, else a ``deconv`` in its name."""
    if model is not None:
        try:
            return isinstance(model.get_submodule(path), torch.nn.ConvTranspose2d)
        except AttributeError:  # not in the model: _check_keys names it
            pass
    return "deconv" in path


def _key(path: str, name: str) -> str:
    return f"{path}.{name}" if path else name


def _leaf_to_torch(
    path: str, name: str, leaf: Any, model: torch.nn.Module | None
) -> tuple[str, torch.Tensor]:
    """One flax leaf at module ``path`` of ``model`` -> (``state_dict``
    key, tensor)."""
    if name == "kernel":
        k = np.asarray(leaf, np.float32)
        if k.ndim == 4:
            w = (deconv_kernel_to_torch(k) if _transposed(path, model)
                 else conv_kernel_to_torch(k))
        elif k.ndim == 2:  # Dense (in, out) -> Linear (out, in)
            w = torch.from_numpy(np.ascontiguousarray(k.T))
        else:  # DenseGeneral: the port keeps flax's layout
            w = _bias(k)
        return _key(path, "weight"), w
    if name == "scale":  # LayerNorm, BatchNorm
        return _key(path, "weight"), _bias(leaf)
    return _key(path, name), _bias(leaf)  # bias, pos_embedding


def _check_keys(sd: Mapping, model: torch.nn.Module, what: str,
                with_stats: bool = True) -> None:
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()
            if with_stats or not is_stat(k)}
    missing = sorted(set(want) - set(sd))
    unknown = sorted(set(sd) - set(want))
    wrong = [f"{k}: {tuple(sd[k].shape)} vs {want[k]}" for k in want
             if k in sd and tuple(sd[k].shape) != want[k]]
    parts = ([f"missing {', '.join(missing[:5])}"] if missing else []) + (
        [f"unknown {', '.join(unknown[:5])}"] if unknown else []) + (
        [f"shapes {'; '.join(wrong[:5])}"] if wrong else [])
    if parts:
        raise ValueError(f"{what} does not match {type(model).__name__}: "
                         + "; ".join(parts))


def flax_to_state_dict(
    params: Mapping, model: torch.nn.Module | None = None,
    batch_stats: Mapping | None = None,
) -> dict[str, torch.Tensor]:
    """A flax params tree of any ported model (and its ``batch_stats``) ->
    the port's ``state_dict`` (float32; ``load_state_dict`` casts to each
    parameter's dtype).

    The port's modules carry the flax tree's names, so the tree is walked
    and each leaf renamed and laid out by its kind: a Conv kernel HWIO ->
    OIHW; a ConvTranspose kernel (by the module's type in ``model``, by a
    ``deconv`` in its path without one) flipped in space and laid out (I,
    O, kh, kw); a Dense kernel (in, out) -> ``Linear.weight`` (out, in); a
    DenseGeneral kernel (the attention projections of models/multicam.py)
    as it is; a LayerNorm or BatchNorm ``scale`` -> ``weight``; biases and
    ``pos_embedding`` as they are; ``batch_stats`` ``mean`` / ``var`` ->
    ``running_mean`` / ``running_var``. With ``model``, the keys and shapes
    are held against its ``state_dict`` (its running averages too where
    ``batch_stats`` is given, {} included) and a difference raises
    ``ValueError`` naming the keys."""
    sd: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Mapping, stats: bool) -> None:
        for name, leaf in node.items():
            if isinstance(leaf, Mapping):
                walk(_key(prefix, name), leaf, stats)
            elif stats:
                sd[_key(prefix, STAT_BUFFERS[name])] = _bias(leaf)
            else:
                key, value = _leaf_to_torch(prefix, name, leaf, model)
                sd[key] = value

    walk("", params, False)
    walk("", batch_stats or {}, True)
    if model is not None:
        _check_keys(sd, model, "the flax variables", with_stats=batch_stats is not None)
    return sd


def state_dict_to_flax(sd: Mapping, model: torch.nn.Module | None = None) -> dict:
    """The port's ``state_dict`` (or the train step's parameters, any device
    and float dtype) -> the flax params tree, float32 numpy: the inverse of
    :func:`flax_to_state_dict`. Running averages are left out (they are
    :func:`batch_stats_to_flax`'s). With ``model``, the keys and shapes are
    held against its parameters first (and against its running averages
    where ``sd`` holds any)."""
    params, stats = split_stats(sd)
    if model is not None:
        _check_keys(sd, model, "the state_dict", with_stats=bool(stats))
    tree: dict = {}
    for key, t in params.items():
        *path, name = key.split(".")
        a = t.detach().float().cpu().numpy()
        if name == "weight":
            if a.ndim == 4 and _transposed(".".join(path), model):  # (I, O, kh, kw), flipped
                a, name = a.transpose(2, 3, 0, 1)[::-1, ::-1], "kernel"
            elif a.ndim == 4:  # (O, I, kh, kw)
                a, name = a.transpose(2, 3, 1, 0), "kernel"
            elif a.ndim == 2:
                a, name = a.T, "kernel"
            elif a.ndim == 1:
                name = "scale"
            else:
                name = "kernel"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    return tree


def batch_stats_to_flax(sd: Mapping) -> dict:
    """The running averages of a ``state_dict`` (or of a ``TrainState``'s
    ``batch_stats``) -> the flax ``batch_stats`` tree, float32 numpy; {}
    where there are none."""
    tree: dict = {}
    for key, t in split_stats(sd)[1].items():
        *path, name = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[_STAT_LEAVES[name]] = np.ascontiguousarray(t.detach().float().cpu().numpy())
    return tree


def basicnet_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``BasicNet`` params (either flavour) -> the port's
    ``state_dict``: :func:`flax_to_state_dict`."""
    return flax_to_state_dict(params)


def basicnet_params_from_state_dict(sd: Mapping) -> dict:
    """The port's ``BasicNet`` ``state_dict`` (or the train step's
    parameters) -> the flax ``BasicNet`` params tree, float32 numpy:
    :func:`state_dict_to_flax`, the inverse of :func:`basicnet_state_dict`.
    A key outside ``encoder.`` and ``decoder.`` raises ``KeyError``."""
    stray = [k for k in sd if k.split(".")[0] not in ("encoder", "decoder")]
    if stray:
        raise KeyError(f"not a BasicNet state_dict: {', '.join(stray[:5])}")
    return state_dict_to_flax(sd)


def _is_pipeline_layout(params) -> bool:
    """True for a pipeline-parallel-trained ViT flax tree (the stacked
    ``blocks`` layout of parallel/pipeline.py, the JAX package's too)."""
    return isinstance(params, Mapping) and "blocks" in params and "embed" in params


def is_pipeline_state_dict(sd: Mapping) -> bool:
    """True for the port's pipelined ViT parameters (``embed.*``,
    ``blocks.*`` stacks, ``final_norm.*``, ``decoder.*``)."""
    return any(k.startswith("blocks.") for k in sd) and any(k.startswith("embed.") for k in sd)


_BLOCK_PARTS = ("attn", "ff")


def pipeline_tree_to_vit(tree: Mapping) -> dict:
    """A flax tree in the pipeline's layout -> ``ViTPoseNet``'s (the JAX
    package's ``pipeline_params_to_vit`` on numpy): row i of each
    ``blocks/{attn,ff}`` stack becomes ``transformer/{attn,ff}{i}``."""
    depth = int(np.asarray(_first_leaf(tree["blocks"])).shape[0])
    transformer: dict = {}
    for i in range(depth):
        for name in _BLOCK_PARTS:
            transformer[f"{name}{i}"] = _tree_map(lambda x: np.asarray(x)[i], tree["blocks"][name])
    transformer["final_norm"] = tree["final_norm"]
    return {"patch_embed": tree["embed"], "transformer": transformer, "decoder": tree["decoder"]}


def vit_tree_to_pipeline(tree: Mapping, depth: int) -> dict:
    """The inverse of :func:`pipeline_tree_to_vit`: the ``depth`` blocks'
    leaves stacked on a leading axis."""
    t = tree["transformer"]
    blocks = {name: _tree_stack([t[f"{name}{i}"] for i in range(depth)])
              for name in _BLOCK_PARTS}
    return {"embed": tree["patch_embed"], "blocks": blocks,
            "final_norm": t["final_norm"], "decoder": tree["decoder"]}


def pipeline_state_dict_to_vit(sd: Mapping) -> dict[str, torch.Tensor]:
    """The port's pipelined ViT parameters -> ``ViTPoseNet``'s
    ``state_dict`` names, in its order: ``embed.*`` -> ``patch_embed.*``,
    row i of ``blocks.{attn,ff}.*`` -> ``transformer.{attn,ff}{i}.*``,
    ``final_norm.*`` -> ``transformer.final_norm.*``, ``decoder.*`` as it
    is."""
    depth = next(v for k, v in sd.items() if k.startswith("blocks.")).shape[0]
    out = {f"patch_embed.{k[6:]}": v for k, v in sd.items() if k.startswith("embed.")}
    for i in range(depth):
        for name in _BLOCK_PARTS:
            pre = f"blocks.{name}."
            out.update({f"transformer.{name}{i}.{k[len(pre):]}": v[i]
                        for k, v in sd.items() if k.startswith(pre)})
    out.update({f"transformer.{k}": v for k, v in sd.items() if k.startswith("final_norm.")})
    out.update({k: v for k, v in sd.items() if k.startswith("decoder.")})
    return out


def vit_state_dict_to_pipeline(sd: Mapping, depth: int) -> dict[str, torch.Tensor]:
    """The inverse of :func:`pipeline_state_dict_to_vit`, in the order of
    parallel/pipeline.py's parameters."""
    out = {f"embed.{k[12:]}": v for k, v in sd.items() if k.startswith("patch_embed.")}
    for name in _BLOCK_PARTS:
        pre = f"transformer.{name}0."
        for k in sd:
            if k.startswith(pre):
                leaf = k[len(pre):]
                out[f"blocks.{name}.{leaf}"] = torch.stack(
                    [torch.as_tensor(sd[f"transformer.{name}{i}.{leaf}"]) for i in range(depth)])
    out.update({k[12:]: v for k, v in sd.items() if k.startswith("transformer.final_norm.")})
    out.update({k: v for k, v in sd.items() if k.startswith("decoder.")})
    return out


def pipeline_flax_to_state_dict(tree: Mapping) -> dict[str, torch.Tensor]:
    """A flax tree in the pipeline's layout -> the port's pipelined
    parameters (each block through :func:`flax_to_state_dict`, then
    stacked)."""
    depth = int(np.asarray(_first_leaf(tree["blocks"])).shape[0])
    return vit_state_dict_to_pipeline(flax_to_state_dict(pipeline_tree_to_vit(tree)), depth)


def pipeline_state_dict_to_flax(sd: Mapping) -> dict:
    """The inverse of :func:`pipeline_flax_to_state_dict`: float32 numpy."""
    depth = next(v for k, v in sd.items() if k.startswith("blocks.")).shape[0]
    return vit_tree_to_pipeline(state_dict_to_flax(pipeline_state_dict_to_vit(sd)), depth)


def moe_params_to_torch(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's MoE parameter dict (``gate``, ``w1``, ``b1``,
    ``w2``, ``b2``) -> the port's (parallel/expert.py): the same layout,
    float32 tensors."""
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in params.items()}


def moe_params_to_numpy(params: Mapping) -> dict[str, np.ndarray]:
    """The inverse of :func:`moe_params_to_torch`."""
    return {k: v.detach().float().cpu().numpy() for k, v in params.items()}


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_stack(trees: list):
    if isinstance(trees[0], Mapping):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees])


def vit_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``ViTPoseNet`` or ``ViT4Cameras`` params (torch or tf flavour),
    or a pipeline-trained ViT's stacked-blocks tree -> the port's
    ``ViTPoseNet`` / ``ViT4Cameras`` ``state_dict``."""
    if _is_pipeline_layout(params):
        params = pipeline_tree_to_vit(params)
    return flax_to_state_dict(params)


def init_vit_params(
    rng: np.random.Generator, in_channels: int, out_channels: int,
    image_size: int, *, patch_size: int = 16, dim: int = 256, depth: int = 8,
    heads: int = 8, dim_head: int = 64, mlp_expand: int = 4,
    kernel_size: int = 3, flavor: str = "torch", four_cameras: bool = False,
    num_fuse_layers: int = 4,
) -> dict:
    """A seeded flax-layout params tree of ``ViTPoseNet`` (or, with
    ``four_cameras``, of ``ViT4Cameras``; ``in_channels`` and
    ``out_channels`` then count all four views).

    Kernels are fan-in scaled normals; biases normals of std 0.05 and
    LayerNorm scales 1 + normals of std 0.05 rather than flax's zeros and
    ones, so a test sees every parameter; ``pos_embedding`` is a unit
    normal, as flax initialises it."""
    def f32(a) -> np.ndarray:
        return np.asarray(a, np.float32)

    def bias(n: int) -> np.ndarray:
        return f32(rng.standard_normal(n) * 0.05)

    def dense(cin: int, cout: int, use_bias: bool = True) -> dict:
        p = {"kernel": f32(rng.standard_normal((cin, cout)) / np.sqrt(cin))}
        if use_bias:
            p["bias"] = bias(cout)
        return p

    def conv(k: int, cin: int, cout: int) -> dict:
        std = 1.0 / np.sqrt(k * k * cin)
        return {"kernel": f32(rng.standard_normal((k, k, cin, cout)) * std),
                "bias": bias(cout)}

    def norm(n: int) -> dict:
        return {"scale": f32(1.0 + rng.standard_normal(n) * 0.05), "bias": bias(n)}

    def transformer(d: int, layers: int, h: int, dh: int, mlp: int, fl: str) -> dict:
        tf = fl == "tf"
        t: dict = {}
        for i in range(layers):
            attn = {"to_qkv": dense(d, 3 * h * dh, use_bias=tf),
                    "to_out": dense(h * dh, d)}
            ff = {"fc1": dense(d, mlp), "fc2": dense(mlp, d)}
            if tf:
                t[f"postnorm{i}a"], t[f"postnorm{i}b"] = norm(d), norm(d)
            else:
                attn["norm"], ff["norm"] = norm(d), norm(d)
            t[f"attn{i}"], t[f"ff{i}"] = attn, ff
        if not tf:
            t["final_norm"] = norm(d)
        return t

    def patch_embed(cin: int, post_norm: bool) -> dict:
        n = (image_size // patch_size) ** 2
        p = {"proj": conv(patch_size, cin, dim),
             "pos_embedding": f32(rng.standard_normal((1, n, dim)))}
        if post_norm:
            p["embed_norm"] = norm(dim)
        return p

    def decoder(k_out: int, fl: str) -> dict:
        widths = ((dim, dim, dim, k_out) if fl == "torch"
                  else (dim // 2, dim // 4, dim // 8, k_out))
        dec, cin = {}, dim
        for i, cout in enumerate(widths):
            dec[f"deconv{i + 1}"] = conv(kernel_size, cin, cout)
            cin = cout
        return dec

    if not four_cameras:
        return {
            "patch_embed": patch_embed(in_channels, flavor == "torch"),
            "transformer": transformer(dim, depth, heads, dim_head,
                                       dim * mlp_expand, flavor),
            "decoder": decoder(out_channels, flavor),
        }
    tree = {
        "patch_embed": patch_embed(in_channels // 4, True),
        "shared_encoder": transformer(dim, depth, heads, dim_head,
                                      dim * mlp_expand, "torch"),
        "shared_decoder": decoder(out_channels // 4, "torch"),
    }
    for i in range(num_fuse_layers):
        tree[f"fuse{i}"] = {
            "transformer": transformer(dim * 5, 1, 4, dim, dim, "torch"),
            "norm": norm(dim * 5), "proj": dense(dim * 5, dim)}
    return tree


def init_basicnet_params(
    rng: np.random.Generator, in_channels: int, out_channels: int,
    filters: int = 64,
) -> dict:
    """A seeded flax-layout torch-flavour 3x3 ``BasicNet`` params tree.

    Kernels are fan-in scaled normals (flax's lecun_normal without the
    truncation); biases are normals of std 0.05 rather than flax's zeros,
    so a test of the bias path sees nonzero biases."""
    k = 3

    def layer(cin: int, cout: int) -> dict:
        std = 1.0 / np.sqrt(k * k * cin)
        return {
            "kernel": (rng.standard_normal((k, k, cin, cout)) * std).astype(
                np.float32),
            "bias": (rng.standard_normal(cout) * 0.05).astype(np.float32),
        }

    enc, chans = {}, in_channels
    for stage, mult in enumerate((1, 2, 4)):
        f = filters * mult
        for i in range(3):
            enc[f"conv{3 * stage + i + 1}"] = layer(chans if i == 0 else f, f)
        chans = f
    half = chans // 2
    dec = {
        "deconv1": layer(chans, half),
        "deconv2": layer(half, half),
        "deconv3": layer(half, half),
        "deconv4": layer(half, out_channels),
    }
    return {"encoder": enc, "decoder": dec}


# -- flax msgpack, without msgpack ---------------------------------------------
# The subset of msgpack (github.com/msgpack/msgpack/blob/master/spec.md) that
# flax's ``msgpack_serialize`` writes: nil, bools, ints, floats, str, bin,
# arrays, maps and ext, where ext 1 holds an ndarray and ext 3 a numpy
# scalar, each a packed (shape, dtype name, raw C-order bytes).
_MSGPACK_FIXED = {  # type byte -> (payload kind, bytes of its length or value)
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4),
    0xCA: ("float", 4), 0xCB: ("float", 8),
    0xCC: ("uint", 1), 0xCD: ("uint", 2), 0xCE: ("uint", 4), 0xCF: ("uint", 8),
    0xD0: ("int", 1), 0xD1: ("int", 2), 0xD2: ("int", 4), 0xD3: ("int", 8),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4), 0xDE: ("map", 2), 0xDF: ("map", 4),
}
_MSGPACK_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_MSGPACK_CONST = {0xC0: None, 0xC2: False, 0xC3: True}
_MAX_LEAF_BYTES = 2 ** 30  # flax splits larger leaves into chunks


class _MsgpackReader:
    """Values decoded in order from one buffer. Inside an ndarray ext the
    raw bytes come back as a ``memoryview`` (``views``), so an array is one
    ``np.frombuffer`` on the file's bytes and no copy."""

    def __init__(self, data, views: bool = False):
        self.data, self.pos, self.views = memoryview(data), 0, views

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack data ends early: {n} bytes wanted at {self.pos},"
                             f" {len(self.data)} in all")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def head(self) -> tuple[str, Any]:
        """The next value's kind and its length (a container, str, bin or
        ext: ``(code, length)``) or its value (every other kind)."""
        b = self.take(1)[0]
        if b < 0x80 or b >= 0xE0:
            return "value", b if b < 0x80 else b - 0x100
        if b < 0xC0:
            return ("map", "array", "str", "str")[(b >> 4) - 8], b & (0x1F if b >= 0xA0 else 0x0F)
        if b in _MSGPACK_CONST:
            return "value", _MSGPACK_CONST[b]
        if b in _MSGPACK_FIXEXT:
            return "ext", (int.from_bytes(self.take(1), "big", signed=True), _MSGPACK_FIXEXT[b])
        if b not in _MSGPACK_FIXED:
            raise ValueError(f"msgpack type byte 0x{b:02X} at {self.pos - 1} is not read")
        kind, n = _MSGPACK_FIXED[b]
        raw = self.take(n)
        if kind == "float":
            return "value", struct.unpack(">f" if n == 4 else ">d", raw)[0]
        v = int.from_bytes(raw, "big", signed=kind == "int")
        if kind in ("int", "uint"):
            return "value", v
        if kind == "ext":
            return "ext", (int.from_bytes(self.take(1), "big", signed=True), v)
        return kind, v

    def value(self):
        kind, arg = self.head()
        if kind == "value":
            return arg
        if kind == "map":
            out = {}
            for _ in range(arg):
                key = self.value()
                if not isinstance(key, (str, bytes)):
                    raise ValueError(f"a msgpack map key of type {type(key).__name__}")
                out[key] = self.value()
            if "__msgpack_chunked_array__" in out:
                raise ValueError("a leaf flax split into chunks (over 1 GiB) is not read")
            return out
        if kind == "array":
            return [self.value() for _ in range(arg)]
        if kind == "str":
            return str(self.take(arg), "utf-8")
        if kind == "bin":
            return self.take(arg) if self.views else bytes(self.take(arg))
        code, n = arg
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"flax msgpack ext type {code} is not an array")
        array = _ndarray_from_bytes(self.take(n))
        return array if code == _EXT_NDARRAY else array[()]


def _ndarray_from_bytes(data) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: a packed (shape, dtype name, buffer);
    bfloat16 widened to float32 (numpy has no bfloat16)."""
    r = _MsgpackReader(data, views=True)
    shape, name, buffer = r.value()
    if r.pos != len(r.data):
        raise ValueError("bytes after an ndarray's (shape, dtype, buffer)")
    name = name if isinstance(name, str) else str(name, "utf-8")
    if name == "bfloat16":
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape)


def unpack_flax_msgpack(blob) -> Any:
    """A flax msgpack payload -> nested dicts (and lists) of numpy arrays,
    numpy scalars and Python values, as ``flax.serialization.msgpack_restore``
    gives them, with neither ``msgpack`` nor jax (bfloat16 leaves widened to
    float32). A type byte or ext code outside what flax writes, or bytes
    that end early or run on, raise ``ValueError``."""
    r = _MsgpackReader(blob)
    tree = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack payload")
    return tree


def _pack_length(out: bytearray, n: int, fix: int | None, fix_max: int, codes) -> None:
    """A str, bin, array, map or ext length in its shortest form: the
    ``fix`` byte's low bits below ``fix_max``, else 1-, 2- or 4-byte forms
    (``codes``, ``None`` where the form does not exist)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, width in zip(codes, (1, 2, 4)):
        if code is not None and n < 1 << (8 * width):
            out.append(code)
            out += n.to_bytes(width, "big")
            return
    raise ValueError(f"a msgpack length of {n}")


def _pack_int(out: bytearray, v: int) -> None:
    if -32 <= v < 128:
        out += (v & 0xFF).to_bytes(1, "big")
        return
    for code, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)) if v > 0 else (
            (0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
        if (v < 1 << (8 * width)) if v > 0 else (v >= -(1 << (8 * width - 1))):
            out.append(code)
            out += v.to_bytes(width, "big", signed=v < 0)
            return
    raise OverflowError(f"{v} does not fit a msgpack integer")


def _pack_array_ext(out: bytearray, code: int, a: np.ndarray) -> None:
    """flax's ``_ndarray_to_bytes`` inside an ext of type ``code``."""
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError(f"a {a.dtype} array is not serialised (flax refuses it)")
    if a.nbytes > _MAX_LEAF_BYTES:
        raise ValueError(f"a leaf of {a.nbytes} bytes: flax writes it in chunks, not written")
    body = bytearray()
    _pack_length(body, 3, 0x90, 16, (None, 0xDC, 0xDD))
    _pack_length(body, len(a.shape), 0x90, 16, (None, 0xDC, 0xDD))
    for d in a.shape:
        _pack_int(body, int(d))
    _pack_value(body, a.dtype.name)
    raw = a.tobytes("C")
    _pack_length(body, len(raw), None, 0, (0xC4, 0xC5, 0xC6))
    body += raw
    n = len(body)
    if n in (1, 2, 4, 8, 16):
        out.append({1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}[n])
    else:
        _pack_length(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += body


def _pack_value(out: bytearray, x) -> None:
    t = type(x)
    if x is None or t is bool:
        out.append({None: 0xC0, False: 0xC2, True: 0xC3}[x])
    elif t is int:
        _pack_int(out, x)
    elif t is float:
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif t is str:
        raw = x.encode("utf-8")
        _pack_length(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif t is bytes:
        _pack_length(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out += x
    elif t is dict:
        _pack_length(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack_value(out, k)
            _pack_value(out, v)
    elif t is list:
        _pack_length(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack_value(out, v)
    elif isinstance(x, np.ndarray):
        _pack_array_ext(out, _EXT_NDARRAY, x)
    elif isinstance(x, np.generic):
        _pack_array_ext(out, _EXT_NPSCALAR, np.asarray(x))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def pack_flax_msgpack(tree) -> bytes:
    """``tree`` (nested dicts and lists of numpy arrays, numpy scalars and
    Python values) as flax's ``serialization.to_bytes`` writes its state
    dict, byte for byte: the shortest encoding of every int and length,
    maps in their insertion order, arrays as ext 1 and numpy scalars as ext
    3, with neither ``msgpack`` nor jax. A tuple, or any other type, raises
    ``TypeError`` as msgpack's strict packer does."""
    out = bytearray()
    _pack_value(out, tree)
    return bytes(out)


# what a run directory may hold, in the order they are read
CHECKPOINT_NAMES = ("best_model.pt", "checkpoint.pt", "best_model.msgpack",
                    "checkpoint.msgpack")


def load_checkpoint(path: str, model: torch.nn.Module | None = None) -> tuple[dict, dict]:
    """``(params, batch_stats)`` as flax-layout numpy trees from a
    checkpoint (``batch_stats`` {} for the models without BatchNorm), the
    reader picked by what is on disk: in a run directory the
    first of :data:`CHECKPOINT_NAMES` present (the port's ``.pt`` files
    before the JAX package's msgpack ones; ``FileNotFoundError`` naming all
    four where none is); a snapshot of an imported reference checkpoint,
    the port's or the JAX package's (importers.py), its trees; a file named
    ``*.pt`` (the port's checkpoints and ``save_params`` snapshots,
    state_dict-named) through :func:`state_dict_to_flax` (``model``, the
    module the weights are for, tells its transposed convs by their type);
    any other file through :func:`load_flax_checkpoint`. A failed read
    raises; the other format is never tried."""
    from .importers import load_imported_snapshot

    if os.path.isdir(path):
        found = [n for n in CHECKPOINT_NAMES if os.path.isfile(os.path.join(path, n))]
        if not found:
            raise FileNotFoundError(
                f"{path}: none of {', '.join(CHECKPOINT_NAMES)} in this run directory")
        path = os.path.join(path, found[0])
    snap = load_imported_snapshot(path)
    if snap is not None:
        return snap.params, snap.batch_stats or {}
    if path.endswith(".pt"):
        from .train.checkpoint import load_variables

        params, stats = load_variables(path)
        if is_pipeline_state_dict(params):  # a pipeline-trained ViT serves as ViTPoseNet
            params = pipeline_state_dict_to_vit(params)
        return state_dict_to_flax(params, model), batch_stats_to_flax(stats)
    return load_flax_checkpoint(path)


def load_flax_checkpoint(path: str) -> tuple[dict, dict]:
    """``(params, batch_stats)`` from a file the JAX package wrote: a
    weights-only snapshot (``save_params``), a full training-state payload
    (``save_checkpoint``: step, params, opt_state, batch_stats, rng) or a
    snapshot of an imported reference checkpoint (``cli import``: its
    ``IMPORT_SNAPSHOT_MAGIC``, then params, batch_stats and the
    architecture). ``path`` may be a run directory, as the JAX
    ``load_variables`` takes one: its ``best_model.msgpack`` is read if
    there, else its ``checkpoint.msgpack``. ``batch_stats`` is ``{}`` where
    there are none. Leaves are numpy arrays; nothing of jax is imported."""
    from .importers import IMPORT_SNAPSHOT_FORMAT, IMPORT_SNAPSHOT_MAGIC

    if os.path.isdir(path):
        names = ("best_model.msgpack", "checkpoint.msgpack")
        found = [n for n in names if os.path.isfile(os.path.join(path, n))]
        if not found:
            raise FileNotFoundError(
                f"{path}: neither {names[0]} nor {names[1]} in this run directory")
        path = os.path.join(path, found[0])
    with open(path, "rb") as f:
        blob = f.read()
    if blob.startswith(IMPORT_SNAPSHOT_MAGIC):
        blob = blob[len(IMPORT_SNAPSHOT_MAGIC):]
    tree = unpack_flax_msgpack(blob)
    batch_stats: dict = {}
    if isinstance(tree, dict) and tree.get("format") == IMPORT_SNAPSHOT_FORMAT:
        batch_stats = tree.get("batch_stats") or {}
        tree = tree["params"]
    elif isinstance(tree, dict) and {"params", "opt_state"} <= set(tree):
        batch_stats = tree.get("batch_stats") or {}
        tree = tree["params"]
    return tree, batch_stats
