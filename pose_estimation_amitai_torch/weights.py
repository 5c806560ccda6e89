"""Weight bridge: flax ``BasicNet`` and ViT params -> the port's tensors.

Input everywhere is a flax ``params`` tree as nested dicts of arrays
(anything ``np.asarray`` takes), the layout the JAX package trains and
checkpoints. Outputs:

* :func:`basicnet_state_dict` — the port's ``BasicNet`` ``state_dict``.
  Conv kernels go HWIO -> OIHW. Every decoder kernel is a flax
  ConvTranspose; the port's layers are ``ConvTranspose2d``, which correlate
  with the kernel flipped in space, so flax kernels are flipped and laid out
  (I, O, kh, kw). A flax stride-1 ConvTranspose(SAME) is an unflipped SAME
  correlation and the torch-flavour stride-2 layer is ``ConvTranspose2d(k3,
  s2, padding=1, output_padding=1)`` on the flipped kernel, so one rule
  covers both.
* :func:`kernel_params` (models/fast_infer.py) — the fused kernels take the
  flax HWIO layout as it is.
* :func:`vit_state_dict` — the ``state_dict`` of the port's ``ViTPoseNet``
  or ``ViT4Cameras`` (either flavour): the port's modules carry the flax
  tree's names, so the tree is walked and each leaf renamed. Dense
  ``kernel`` (in, out) -> ``Linear.weight`` (out, in); the patch-embed conv
  HWIO -> OIHW; deconvs flipped and permuted as above; LayerNorm ``scale``
  -> ``weight``; ``pos_embedding`` as it is.

:func:`load_flax_checkpoint` reads what ``train/checkpoint.py`` writes
(flax msgpack) with a lazy ``import msgpack`` and no jax;
:func:`init_basicnet_params` and :func:`init_vit_params` make seeded
flax-layout trees with numpy.
"""

from __future__ import annotations

import os
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


def basicnet_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """flax torch-flavour ``BasicNet`` params -> the port's ``state_dict``
    (float32; ``load_state_dict`` casts to the module's dtype)."""
    sd: dict[str, torch.Tensor] = {}
    enc, dec = params["encoder"], params["decoder"]
    for i in range(1, 10):
        sd[f"encoder.conv{i}.weight"] = conv_kernel_to_torch(
            enc[f"conv{i}"]["kernel"])
        sd[f"encoder.conv{i}.bias"] = _bias(enc[f"conv{i}"]["bias"])
    for i in range(1, 5):
        sd[f"decoder.deconv{i}.weight"] = deconv_kernel_to_torch(
            dec[f"deconv{i}"]["kernel"])
        sd[f"decoder.deconv{i}.bias"] = _bias(dec[f"deconv{i}"]["bias"])
    return sd


def _is_pipeline_layout(params) -> bool:
    """True for a pipeline-parallel-trained ViT tree (stacked ``blocks``
    layout of the JAX package's parallel/pipeline.py)."""
    return isinstance(params, Mapping) and "blocks" in params and "embed" in params


def vit_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``ViTPoseNet`` or ``ViT4Cameras`` params (torch or tf flavour)
    -> the port's ``state_dict`` (float32; ``load_state_dict`` casts to each
    parameter's dtype). Keys are the flax paths joined with dots."""
    if _is_pipeline_layout(params):
        raise NotImplementedError(
            "pipeline-layout ViT checkpoints (stacked blocks) come with the "
            "parallel strategies, ROADMAP Queue A item 14")
    sd: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Mapping) -> None:
        for name, leaf in node.items():
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(leaf, Mapping):
                walk(path, leaf)
            elif name == "kernel":
                k = np.asarray(leaf, np.float32)
                if k.ndim == 2:  # Dense (in, out) -> Linear (out, in)
                    w = torch.from_numpy(np.ascontiguousarray(k.T))
                elif "deconv" in prefix:
                    w = deconv_kernel_to_torch(k)
                else:
                    w = conv_kernel_to_torch(k)
                sd[f"{prefix}.weight"] = w
            elif name == "scale":  # LayerNorm
                sd[f"{prefix}.weight"] = _bias(leaf)
            else:  # bias, pos_embedding
                sd[path] = _bias(leaf)

    walk("", params)
    return sd


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


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # numpy has no bfloat16: widen the raw 16-bit patterns to float32
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"flax msgpack ext type {code} is not an array")


def load_flax_checkpoint(path: str) -> tuple[dict, dict]:
    """``(params, batch_stats)`` from a file ``train/checkpoint.py`` wrote:
    a weights-only snapshot (``save_params``) or a full training-state
    payload (``save_checkpoint``: step, params, opt_state, batch_stats,
    rng). ``path`` may be a run directory, as the JAX ``load_variables``
    takes one: its ``best_model.msgpack`` is read if there, else its
    ``checkpoint.msgpack``. ``batch_stats`` is ``{}`` where there are none.
    Leaves are numpy arrays; nothing of jax is imported. (Snapshots of
    imported reference checkpoints are ROADMAP Queue A item 13.)"""
    import msgpack

    if os.path.isdir(path):
        names = ("best_model.msgpack", "checkpoint.msgpack")
        found = [n for n in names if os.path.isfile(os.path.join(path, n))]
        if not found:
            raise FileNotFoundError(
                f"{path}: neither {names[0]} nor {names[1]} in this run directory")
        path = os.path.join(path, found[0])
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    batch_stats: dict = {}
    if isinstance(tree, dict) and {"params", "opt_state"} <= set(tree):
        batch_stats = tree.get("batch_stats") or {}
        tree = tree["params"]
    return tree, batch_stats
