"""Reference-checkpoint importers: keras ``.h5`` / torch ``state_dict`` /
TorchScript -> flax-layout parameter trees -> the port's modules (PyTorch
port).

Counterpart of ``pose_estimation_amitai_tpu/importers.py``. The reference
trains two stacks whose checkpoints downstream users hold:

* keras ``.h5`` full-model saves (``best_model.h5`` /
  ``final_confmaps_model.h5`` -- tensorflow/train.py:88-104,
  tensorflow/CallBacks.py:122-128)
* torch ``checkpoint.pth`` dicts (``model_state_dict`` key,
  pytorch/train_pytorch.py:253-260) and TorchScript ``best_model.pth``
  (pytorch/train_pytorch.py:177-181)

Each importer maps a checkpoint onto the flax-layout numpy tree that the
JAX package's importer produces for it -- the same mapping, copied, so the
two agree key for key and bit for bit -- together with the architecture
(``model_kind``, ``arch_flavor``, ``arch_kwargs``) inferred from the weight
shapes. :meth:`ImportedModel.build_model` then builds the port's
``nn.Module`` and loads the tree through ``weights.flax_to_state_dict``,
the bridge every model family already goes through, with the model passed
(so a transposed conv is told by its type). Layout notes:

* torch ``Conv2d`` kernels (O, I, kh, kw) are plain correlations ->
  transpose to flax (kh, kw, I, O).
* torch ``ConvTranspose2d`` is the *adjoint* of a correlation: the flax
  kernel is the spatially flipped transpose; the reference's ``padding=1,
  output_padding=1`` crop convention is the models' torch-flavour deconv
  padding (models/layers.py ``Deconv``).
* keras ``Conv2D`` kernels (kh, kw, I, O) copy straight through; keras
  ``Conv2DTranspose`` kernels (kh, kw, O, I) flip spatially and swap I/O.
* the reference ViT decoder's scrambled token reshape (pytorch/VITs.py:40)
  is the port's ``ViTPoseNet(ref_token_grid=True)``.

Files are told apart by what they hold, never by a failed read: HDF5 by its
8-byte signature (``h5py`` is imported only to read a keras file, and the
card's machine has none), a TorchScript archive by its ``code/`` entries and
``constants.pkl``, a ``torch.save`` archive by the keys of its state dict.
The port's own ``.pt`` files are ``torch.save`` archives too; their keys are
the port's module names, which match no reference layout. Snapshots of
imported checkpoints (``cli import``) are ``torch.save`` files carrying
:data:`SNAPSHOT_MARKER`; the JAX package's snapshots (magic + flax
msgpack) are read through the port's jax-free msgpack reader.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import zipfile
from typing import Any

import numpy as np
import torch

__all__ = [
    "ImportedModel",
    "import_torch_checkpoint",
    "import_keras_h5",
    "import_reference_checkpoint",
    "is_reference_checkpoint",
    "save_imported_snapshot",
    "load_imported_snapshot",
    "adapt_stem_in_channels",
]

HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"


def is_hdf5(path: str) -> bool:
    """True for a file that starts with the HDF5 signature."""
    if not os.path.isfile(path):
        return False
    with open(path, "rb") as f:
        return f.read(len(HDF5_SIGNATURE)) == HDF5_SIGNATURE


def archive_kind(path: str) -> str | None:
    """``"torchscript"`` or ``"torch_save"`` for a zip archive that
    ``torch.jit.save`` or ``torch.save`` wrote (a TorchScript archive holds
    ``code/`` entries and ``constants.pkl``; a ``torch.save`` one a
    ``data.pkl`` and neither), else ``None``."""
    if not os.path.isfile(path) or not zipfile.is_zipfile(path):
        return None
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
    if any("/code/" in n for n in names) and any(
            n.endswith("/constants.pkl") for n in names):
        return "torchscript"
    if any(n.endswith("/data.pkl") for n in names):
        return "torch_save"
    return None


def _torch_payload(path: str):
    """What a ``torch.save`` archive holds (tensors and plain containers
    only), memory-mapped: reading the keys does not read the tensors."""
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def _state_dict_of(obj) -> dict | None:
    """The state dict a ``torch.save`` payload carries: its
    ``model_state_dict`` (pytorch/train_pytorch.py:253-260 checkpoint
    layout), or the payload itself when it is a dict of tensors."""
    if isinstance(obj, dict) and isinstance(obj.get("model_state_dict"), dict):
        return obj["model_state_dict"]
    if isinstance(obj, dict) and obj and all(torch.is_tensor(v) for v in obj.values()):
        return obj
    return None


def reference_torch_kind(keys) -> str | None:
    """Which reference model a torch state dict's keys belong to:
    ``"vit"``, ``"disentangled"``, ``"multicam"``, ``"resnet_encoder"``
    (a torchvision resnet50 trunk) or ``"basic_cnn"`` -- JAX's tests in
    ``import_torch_checkpoint``, in its order, except that a BasicNet needs
    its ``conv2dTranspose`` decoder beside its encoder convs (its importer
    reads both; the port's own BasicNet names them ``deconv``). ``None``
    for anything else."""
    keys = set(keys)
    if any(k.startswith("vit_encoder.") for k in keys):
        return "vit"
    if "rearrange_layer_1.weight" in keys:
        return "disentangled"
    if "shared_conv2d.weight" in keys:
        return "multicam"
    if "layer1.0.conv1.weight" in keys and "conv1.weight" in keys:
        return "resnet_encoder"
    if any(k.startswith("encoder.conv") for k in keys) and any(
            k.startswith("decoder.conv2dTranspose") for k in keys):
        return "basic_cnn"
    return None


def is_reference_checkpoint(path: str) -> bool:
    """Whether ``path`` is a reference-stack checkpoint, by its content:
    a keras ``model.save`` file (HDF5 with a ``model_weights`` group), a
    TorchScript archive, or a ``torch.save`` archive whose state dict has a
    reference layout (:func:`reference_torch_kind`). The port's own
    checkpoints, snapshots and run directories are none of these, nor are
    the JAX package's msgpack files."""
    if is_hdf5(path):
        import h5py

        with h5py.File(path, "r") as f:
            return "model_weights" in f
    kind = archive_kind(path)
    if kind == "torchscript":
        return True
    if kind == "torch_save":
        sd = _state_dict_of(_torch_payload(path))
        return sd is not None and reference_torch_kind(sd) is not None
    return False


def _module_image_size(params: dict, patch_size: int) -> int:
    """A ViT's square input side, from its positional table's token count."""
    n = params["patch_embed"]["pos_embedding"].shape[1]
    side = math.isqrt(int(n))
    if side * side != n:
        raise ValueError(f"{n} positional tokens are not a square grid")
    return side * patch_size


@dataclasses.dataclass
class ImportedModel:
    """A converted checkpoint: flax-layout params (numpy) + how to build
    its module."""

    params: dict
    model_kind: str  # "basic_cnn" | "vit" | "multicam" | "disentangled" | ...
    arch_flavor: str  # "torch" | "tf"
    arch_kwargs: dict[str, Any]
    batch_stats: dict | None = None  # BN running stats (flax batch_stats)

    def module(self, dtype: torch.dtype = torch.float32, **serving) -> torch.nn.Module:
        """The port's module of this architecture, with no weights loaded,
        on the current default device (``with torch.device("meta")`` for
        the geometry only). ``serving``: a ViT's serving switches
        (``normalize_output``, ``fast_softmax``, ``fused_attention``, ...);
        a CNN takes none. Raises ``ValueError`` for the encoder-only
        torchvision import, which has no decoder to serve."""
        kw = dict(self.arch_kwargs)
        cin = kw.pop("in_channels")
        kw["dtype"] = dtype
        kind, flavor = self.model_kind, self.arch_flavor
        if kind == "resnet_encoder":
            raise ValueError(
                "a torchvision resnet50 state_dict is an ENCODER-INIT "
                "checkpoint (no decoder weights) -- use it via the config's "
                "pretrained_encoder_path, not as a full serving model")
        if kind == "vit":
            from .models.vit import ViTPoseNet

            size = _module_image_size(self.params, kw["patch_size"])
            return ViTPoseNet(cin, size, flavor=flavor, **kw, **serving)
        if serving:
            raise TypeError(f"a {kind} model takes no serving switches, got {sorted(serving)}")
        if kind == "basic_cnn":
            from .models.cnn import BasicNet

            return BasicNet(cin, flavor=flavor, **kw)
        if kind == "multicam":
            from .models.multicam import MultiCamNet

            return MultiCamNet(cin, flavor=flavor, **kw)
        if kind == "two_wings":
            from .models.cnn import TwoWingsNet

            return TwoWingsNet(cin, flavor=flavor, **kw)
        if kind == "disentangled":
            from .models.disentangled import FourCamDisentangled

            return FourCamDisentangled(cin, flavor=flavor, **kw)
        if kind == "c2f":
            from .models.cnn import C2FPerWing

            return C2FPerWing(cin, flavor=flavor, **kw)
        if kind == "resnet":
            from .models.resnet import ResNetHeatmapNet

            return ResNetHeatmapNet(cin, flavor=flavor, **kw)
        raise ValueError(f"unknown model kind {kind!r}")

    def build_model(
        self, device: torch.device | str, dtype: torch.dtype = torch.float32,
        **serving,
    ) -> torch.nn.Module:
        """The port's module with these weights loaded (through
        ``weights.flax_to_state_dict`` with the model, its running averages
        included where there are any), in eval mode, on ``device``."""
        from . import weights

        with torch.device("meta"):
            model = self.module(dtype, **serving)
        sd = weights.flax_to_state_dict(
            self.params, model, self.batch_stats if self.batch_stats else None)
        model = model.to_empty(device=device).eval()
        model.load_state_dict(sd)
        return model


# ---------------------------------------------------------------------------
# weight-layout conversions (see module docstring for derivations)
# ---------------------------------------------------------------------------
def _t_conv(w: np.ndarray) -> np.ndarray:
    """torch Conv2d (O, I, kh, kw) -> flax Conv (kh, kw, I, O)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _t_deconv(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (I, O, kh, kw) -> flax ConvTranspose
    (kh, kw, I, O): spatial flip + move channel axes (adjoint-of-
    correlation semantics)."""
    return np.ascontiguousarray(np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1)))


def _t_dense(w: np.ndarray) -> np.ndarray:
    """torch Linear (out, in) -> flax Dense (in, out)."""
    return np.ascontiguousarray(w.T)


def _k_deconv(w: np.ndarray) -> np.ndarray:
    """keras Conv2DTranspose (kh, kw, O, I) -> flax (kh, kw, I, O)."""
    return np.ascontiguousarray(np.transpose(w[::-1, ::-1], (0, 1, 3, 2)))


# ---------------------------------------------------------------------------
# torch
# ---------------------------------------------------------------------------
def _load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """A state dict from a TorchScript archive (``best_model.pth``), a
    ``checkpoint.pth`` dict or a raw ``state_dict`` save, told apart by the
    archive's content (:func:`archive_kind`)."""
    kind = archive_kind(path)
    if kind == "torchscript":
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    elif kind == "torch_save":
        sd = _state_dict_of(torch.load(path, map_location="cpu", weights_only=True))
        if sd is None:
            raise ValueError(f"{path}: no state dict in this torch.save archive")
    else:
        raise ValueError(f"{path}: neither a TorchScript nor a torch.save archive")
    return {k: np.asarray(v.detach().cpu().numpy(), np.float32)
            for k, v in sd.items()}


def _import_torch_basicnet(sd: dict[str, np.ndarray]) -> ImportedModel:
    """Reference BasicNet (pytorch/CNNs.py:160-186): ``encoder.conv{1..9}``
    + ``decoder.conv2dTranspose{1..4}`` (bn* constructed but bypassed in the
    active forward — pytorch/CNNs.py:75-88 — so deliberately dropped)."""
    enc, dec = _enc_dec_trees(sd, "encoder", "decoder")
    w1 = sd["encoder.conv1.weight"]  # (filters, in_ch, k, k)
    out_ch = sd["decoder.conv2dTranspose4.weight"].shape[1]
    # dilation is not recoverable from shapes; the reference always runs
    # dilation 2 ("dilation rate" in both train_config.json dialects)
    arch = dict(
        out_channels=int(out_ch), filters=int(w1.shape[0]),
        kernel_size=int(w1.shape[2]), dilation=2,
        in_channels=int(w1.shape[1]),
    )
    return ImportedModel(
        params={"encoder": enc, "decoder": dec},
        model_kind="basic_cnn", arch_flavor="torch", arch_kwargs=arch,
    )


def _import_torch_vit(
    sd: dict[str, np.ndarray], dim_head: int | None = None
) -> ImportedModel:
    """Reference VIT_encoder_CNN_decoder (pytorch/VITs.py:197-229):
    ``vit_encoder.*`` (CustomViT, pytorch_vit_encoder.py:107-149) +
    ``cnn_decoder.deconv{1..4}`` (VITs.py:13-58)."""
    emb_w = sd["vit_encoder.patch_to_embedding.weight"]  # (dim, patch_dim)
    dim = emb_w.shape[0]
    pos = sd["vit_encoder.pos_embedding"]  # (1, N, dim)

    # depth / heads / dim_head from the transformer blocks
    depth = 0
    while f"vit_encoder.transformer.layers.{depth}.0.to_qkv.weight" in sd:
        depth += 1
    qkv0 = sd["vit_encoder.transformer.layers.0.0.to_qkv.weight"]
    inner = qkv0.shape[0] // 3
    # inner = heads * dim_head, and the (heads, dim_head) split changes the
    # attention math, but only their product is shape-recoverable. The
    # reference picks dim_head = projection_dim when config "dim head" is
    # truthy (the committed config's setting) else 64 (pytorch/VITs.py:212)
    # — prefer the committed-config reading, fall back to 64. When BOTH
    # readings are shape-consistent the guess can be silently wrong for a
    # dim_head=64 training run — warn and point at the explicit override
    # (``import_reference_checkpoint(..., dim_head=...)`` / CLI
    # ``--dim-head``).
    if dim_head is None:
        dim_head = dim if inner % dim == 0 else 64
        if inner % dim == 0 and inner % 64 == 0 and dim != 64:
            import warnings

            warnings.warn(
                f"ViT qkv width {inner} is divisible by both dim={dim} and "
                f"64 — assuming dim_head={dim} (the committed config's "
                "'dim head' truthy reading, pytorch/VITs.py:212). If this "
                "checkpoint was trained with 'dim head' falsy, pass "
                "dim_head=64 explicitly (CLI: --dim-head 64).",
                stacklevel=3,
            )
    if inner % dim_head:
        raise ValueError(
            f"qkv width {inner} is not divisible by dim_head {dim_head}"
        )
    heads = inner // dim_head

    # patch size & input channels from patch_dim = C * p * p; the decoder
    # grid fixes N = (img/p)^2 — the reference runs 192px/16 -> 144 tokens
    patch_dim = emb_w.shape[1]
    n_tokens = pos.shape[1]

    def blk(i: int) -> tuple[dict, dict]:
        p = f"vit_encoder.transformer.layers.{i}"
        attn = {
            "norm": {"scale": sd[f"{p}.0.norm.weight"],
                     "bias": sd[f"{p}.0.norm.bias"]},
            "to_qkv": {"kernel": _t_dense(sd[f"{p}.0.to_qkv.weight"])},
        }
        if f"{p}.0.to_out.0.weight" in sd:
            attn["to_out"] = {
                "kernel": _t_dense(sd[f"{p}.0.to_out.0.weight"]),
                "bias": sd[f"{p}.0.to_out.0.bias"],
            }
        else:  # project_out=False -> nn.Identity (pytorch_vit_encoder.py:54)
            attn["to_out"] = {
                "kernel": np.eye(inner, dtype=np.float32),
                "bias": np.zeros((inner,), np.float32),
            }
        ff = {
            "norm": {"scale": sd[f"{p}.1.net.0.weight"],
                     "bias": sd[f"{p}.1.net.0.bias"]},
            "fc1": {"kernel": _t_dense(sd[f"{p}.1.net.1.weight"]),
                    "bias": sd[f"{p}.1.net.1.bias"]},
            "fc2": {"kernel": _t_dense(sd[f"{p}.1.net.4.weight"]),
                    "bias": sd[f"{p}.1.net.4.bias"]},
        }
        return attn, ff

    transformer: dict[str, Any] = {}
    for i in range(depth):
        attn, ff = blk(i)
        transformer[f"attn{i}"] = attn
        transformer[f"ff{i}"] = ff
    transformer["final_norm"] = {
        "scale": sd["vit_encoder.transformer.norm.weight"],
        "bias": sd["vit_encoder.transformer.norm.bias"],
    }

    mlp_hidden = sd["vit_encoder.transformer.layers.0.1.net.1.weight"].shape[0]

    # patch embedding: torch Linear over (c, ph, pw)-ordered patch pixels
    # -> our strided-conv kernel (ph, pw, c, dim). p is recovered from
    # patch_dim once C is known; reference inputs are 4-channel
    # (pytorch_vit_encoder.py:107 num_image_channels=4)
    in_ch = 4
    p = int(round((patch_dim / in_ch) ** 0.5))
    assert in_ch * p * p == patch_dim, (
        f"patch_dim {patch_dim} is not 4*p^2; non-default channel count?"
    )
    proj_kernel = np.ascontiguousarray(
        emb_w.reshape(dim, in_ch, p, p).transpose(2, 3, 1, 0)
    )
    patch_embed = {
        "proj": {"kernel": proj_kernel,
                 "bias": sd["vit_encoder.patch_to_embedding.bias"]},
        "embed_norm": {"scale": sd["vit_encoder.norm.weight"],
                       "bias": sd["vit_encoder.norm.bias"]},
        "pos_embedding": pos,
    }

    decoder = {}
    for i in range(1, 5):
        decoder[f"deconv{i}"] = {
            "kernel": _t_deconv(sd[f"cnn_decoder.deconv{i}.weight"]),
            "bias": sd[f"cnn_decoder.deconv{i}.bias"],
        }
    out_ch = sd["cnn_decoder.deconv4.weight"].shape[1]
    k_dec = sd["cnn_decoder.deconv1.weight"].shape[2]

    arch = dict(
        out_channels=int(out_ch), patch_size=p, dim=int(dim),
        depth=depth, heads=int(heads), dim_head=int(dim_head),
        mlp_expand=int(round(mlp_hidden / dim)), kernel_size=int(k_dec),
        ref_token_grid=True,  # pytorch/VITs.py:40 scrambled reshape
        in_channels=in_ch,
    )
    params = {
        "patch_embed": patch_embed,
        "transformer": transformer,
        "decoder": decoder,
    }
    del n_tokens  # informational only; grid side inferred at trace time
    return ImportedModel(params=params, model_kind="vit",
                         arch_flavor="torch", arch_kwargs=arch)


def _enc_dec_trees(sd: dict[str, np.ndarray], enc_prefix: str,
                   dec_prefix: str) -> tuple[dict, dict]:
    enc = {
        f"conv{i}": {
            "kernel": _t_conv(sd[f"{enc_prefix}.conv{i}.weight"]),
            "bias": sd[f"{enc_prefix}.conv{i}.bias"],
        }
        for i in range(1, 10)
    }
    dec = {
        f"deconv{i}": {
            "kernel": _t_deconv(sd[f"{dec_prefix}.conv2dTranspose{i}.weight"]),
            "bias": sd[f"{dec_prefix}.conv2dTranspose{i}.bias"],
        }
        for i in range(1, 5)
    }
    return enc, dec


def _import_torch_multicam(sd: dict[str, np.ndarray]) -> ImportedModel:
    """Reference FourCamerasBaseLine (pytorch/CNNs.py:189-237):
    ``shared_encoder.conv1-9`` + ``shared_conv2d`` (1x1 fused latent) +
    ``shared_decoder.conv2dTranspose1-4``."""
    enc, dec = _enc_dec_trees(sd, "shared_encoder", "shared_decoder")
    params = {
        "shared_encoder": enc,
        "shared_decoder": dec,
        "fusion_conv": {
            "kernel": _t_conv(sd["shared_conv2d.weight"]),
            "bias": sd["shared_conv2d.bias"],
        },
    }
    w1 = sd["shared_encoder.conv1.weight"]
    out_per_view = sd["shared_decoder.conv2dTranspose4.weight"].shape[1]
    arch = dict(
        out_channels=int(4 * out_per_view), num_cams=4,
        filters=int(w1.shape[0]), kernel_size=int(w1.shape[2]), dilation=2,
        in_channels=int(4 * w1.shape[1]),
    )
    return ImportedModel(params=params, model_kind="multicam",
                         arch_flavor="torch", arch_kwargs=arch)


def _import_torch_disentangled(sd: dict[str, np.ndarray]) -> ImportedModel:
    """Reference FourCamerasDisentanglement (pytorch/CNNs.py:240-324):
    shared encoder/decoder + 1x1 rearrange/fusion convs + the three
    ACTIVE BatchNorms (running stats imported as flax batch_stats). The
    reference's raw-memory FTL reshape is reproduced by building the
    model with ``ref_ftl_layout=True`` (models/disentangled.py)."""
    enc, dec = _enc_dec_trees(sd, "shared_encoder", "shared_decoder")
    params = {
        "shared_encoder": enc,
        "shared_decoder": dec,
        "rearrange1": {"kernel": _t_conv(sd["rearrange_layer_1.weight"]),
                       "bias": sd["rearrange_layer_1.bias"]},
        "rearrange2": {"kernel": _t_conv(sd["rearrange_layer_2.weight"]),
                       "bias": sd["rearrange_layer_2.bias"]},
        "fusion1": {"kernel": _t_conv(sd["fusion_layer_1.weight"]),
                    "bias": sd["fusion_layer_1.bias"]},
        "fusion2": {"kernel": _t_conv(sd["fusion_layer_2.weight"]),
                    "bias": sd["fusion_layer_2.bias"]},
    }
    batch_stats = {}
    for i in (1, 2, 3):
        params[f"bn{i}"] = {
            "scale": sd[f"batch_norm{i}.weight"],
            "bias": sd[f"batch_norm{i}.bias"],
        }
        batch_stats[f"bn{i}"] = {
            "mean": sd[f"batch_norm{i}.running_mean"],
            "var": sd[f"batch_norm{i}.running_var"],
        }
    w1 = sd["shared_encoder.conv1.weight"]
    out_per_view = sd["shared_decoder.conv2dTranspose4.weight"].shape[1]
    arch = dict(
        out_channels=int(4 * out_per_view),
        filters=int(w1.shape[0]), kernel_size=int(w1.shape[2]), dilation=2,
        latent_3d_channels=int(sd["rearrange_layer_1.weight"].shape[0]),
        ref_ftl_layout=True,  # pytorch/CNNs.py:335, 348 raw reshape
        in_channels=int(4 * w1.shape[1]),
    )
    return ImportedModel(params=params, model_kind="disentangled",
                         arch_flavor="torch", arch_kwargs=arch,
                         batch_stats=batch_stats)


def _import_torchvision_resnet50(sd: dict[str, np.ndarray]) -> ImportedModel:
    """torchvision ``resnet50`` ``state_dict`` -> encoder-init weights for
    ``ResNet50Encoder(flavor='torch')``.

    The reference's torch warehouse uses ``models.resnet50(pretrained=True)``
    as a truncated encoder (pytorch/NNs warehouse/NNs.py:20-25); this maps
    the full torchvision trunk (stem + layer1-4, BN running stats included)
    onto the bottleneck encoder so ``pretrained_encoder_path`` can
    point straight at a torchvision checkpoint. Classifier (``fc.*``) and
    ``num_batches_tracked`` entries are ignored. The result is an
    ENCODER-ONLY import (model_kind 'resnet_encoder'): graft it as encoder
    init, don't serve it standalone.
    """
    enc: dict[str, Any] = {"stem": {"kernel": _t_conv(sd["conv1.weight"])}}
    stats: dict[str, Any] = {}

    def bn(src: str, dst_p: dict, dst_s: dict, key: str) -> None:
        dst_p[key] = {"scale": sd[f"{src}.weight"],
                      "bias": sd[f"{src}.bias"]}
        dst_s[key] = {"mean": sd[f"{src}.running_mean"],
                      "var": sd[f"{src}.running_var"]}

    bn("bn1", enc, stats, "stem_bn")
    stage_sizes: list[int] = []
    for layer in range(1, 5):
        blocks = 0
        while f"layer{layer}.{blocks}.conv1.weight" in sd:
            blocks += 1
        stage_sizes.append(blocks)
        for b in range(blocks):
            pfx = f"layer{layer}.{b}"
            blk_p: dict[str, Any] = {}
            blk_s: dict[str, Any] = {}
            for j in (1, 2, 3):
                blk_p[f"conv{j}"] = {
                    "kernel": _t_conv(sd[f"{pfx}.conv{j}.weight"])
                }
                bn(f"{pfx}.bn{j}", blk_p, blk_s, f"bn{j}")
            if f"{pfx}.downsample.0.weight" in sd:
                blk_p["conv_proj"] = {
                    "kernel": _t_conv(sd[f"{pfx}.downsample.0.weight"])
                }
                bn(f"{pfx}.downsample.1", blk_p, blk_s, "bn_proj")
            name = f"stage{layer - 1}_block{b}"
            enc[name] = blk_p
            stats[name] = blk_s
    arch = dict(
        in_channels=int(sd["conv1.weight"].shape[1]),
        stage_sizes=stage_sizes,
    )
    return ImportedModel(
        params={"encoder": enc}, model_kind="resnet_encoder",
        arch_flavor="torch", arch_kwargs=arch,
        batch_stats={"encoder": stats},
    )


def adapt_stem_in_channels(kernel: np.ndarray, target_cin: int) -> np.ndarray:
    """Adapt a (kh, kw, C, O) stem kernel to ``target_cin`` input channels.

    ImageNet trunks have a 3-channel stem; this dataset's frames carry 4+
    channels (3 time channels + wing masks). Inflation: every target
    channel gets ``kernel.sum(channels) / target_cin``, so an input whose
    channels are all equal (grayscale-replicated) produces EXACTLY the
    trunk's response to the equivalent RGB input — total response
    magnitude is preserved (sum over target channels == original sum).
    """
    if kernel.shape[2] == target_cin:
        return kernel
    summed = kernel.sum(axis=2, keepdims=True) / float(target_cin)
    return np.ascontiguousarray(
        np.broadcast_to(summed, kernel.shape[:2] + (target_cin,)
                        + kernel.shape[3:]).astype(kernel.dtype)
    )


def import_torch_checkpoint(
    path: str, dim_head: int | None = None
) -> ImportedModel:
    """Import a reference torch checkpoint (TorchScript ``best_model.pth``,
    ``checkpoint.pth`` dict, raw ``state_dict`` save, the self-supervision
    weights, or a torchvision ``resnet50`` trunk for encoder init).

    ``dim_head``: explicit (heads, dim_head) split for ViT checkpoints —
    only the product is shape-recoverable (see ``_import_torch_vit``).
    """
    sd = _load_torch_state_dict(path)
    kind = reference_torch_kind(sd)
    if kind == "vit":
        return _import_torch_vit(sd, dim_head=dim_head)
    if kind is not None:
        return {"disentangled": _import_torch_disentangled,
                "multicam": _import_torch_multicam,
                "resnet_encoder": _import_torchvision_resnet50,
                "basic_cnn": _import_torch_basicnet}[kind](sd)
    raise ValueError(
        "unrecognised torch state dict — expected reference BasicNet "
        "(encoder.conv*), FourCamerasBaseLine (shared_conv2d.*), "
        "FourCamerasDisentanglement (rearrange_layer_*), "
        "VIT_encoder_CNN_decoder (vit_encoder.*), or torchvision resnet50 "
        "(layer1.0.*) keys; "
        f"got {sorted(sd)[:8]} ..."
    )


# ---------------------------------------------------------------------------
# keras .h5
# ---------------------------------------------------------------------------
def _keras_weight_list(path: str) -> list[tuple[str, np.ndarray]]:
    """All weights of a keras .h5 save, in the model's layer order.

    Handles both ``model.save`` files (weights under ``model_weights``) and
    ``save_weights`` files (layers at the root), including nested
    sub-models (the reference's basic_nn nests Encoder2DAtrous/Decoder2D
    Models — tensorflow/Network.py:478-489).
    """
    import h5py

    out: list[tuple[str, np.ndarray]] = []
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def layer_names(g):
            names = g.attrs.get("layer_names")
            if names is not None:
                return [n.decode() if isinstance(n, bytes) else n
                        for n in names]
            return list(g.keys())

        def visit(g):
            for name in layer_names(g):
                if name not in g:
                    continue
                sub = g[name]
                wn = sub.attrs.get("weight_names")
                if wn is not None and len(wn):
                    for w in wn:
                        w = w.decode() if isinstance(w, bytes) else w
                        ds = sub[w] if w in sub else root[w]
                        out.append((w, np.asarray(ds, np.float32)))
                elif isinstance(sub, h5py.Group):
                    visit(sub)

        visit(root)
    return out


def import_keras_vit(weights: list[tuple[str, np.ndarray]]) -> ImportedModel:
    """Import the reference TF ViT (tensorflow/vitPose.py:100-130).

    Structure: Dense patch embedding over (ph, pw, c)-flattened
    ``extract_patches`` output (same order as the strided-conv
    kernel), Embedding positional table, N transformer layers of
    [keras MultiHeadAttention (biased q/k/v), LayerNorm, Dense(relu),
    Dense, LayerNorm] (post-LN), and 4 channel-halving Conv2DTranspose
    decoders with LeakyReLU(0.1). Matching is shape- and name-suffix
    driven (keras auto-names layers, but MHA sub-weights keep their
    ``query/key/value/attention_output`` suffixes)."""

    def sub(name):
        return name.rsplit("/", 1)[0]

    by_layer: dict[str, dict[str, np.ndarray]] = {}
    order: list[str] = []
    for name, w in weights:
        lay = sub(name)
        if lay not in by_layer:
            by_layer[lay] = {}
            order.append(lay)
        by_layer[lay][name.rsplit("/", 1)[1]] = w

    def mha_part(lay):
        low = lay.lower()
        for part, tag in (("o", "attention_output"), ("q", "query"),
                          ("k", "key"), ("v", "value")):
            if tag in low:
                return part
        return None

    mha_groups: dict[str, dict[str, tuple]] = {}
    mha_order: list[str] = []
    dense2d: list[tuple[str, np.ndarray, np.ndarray]] = []
    ln_pairs: list[tuple[np.ndarray, np.ndarray]] = []
    deconvs: list[tuple[np.ndarray, np.ndarray]] = []
    pos = None

    for lay in order:
        ws = by_layer[lay]
        kern = ws.get("kernel:0")
        part = mha_part(lay)
        if part is not None and kern is not None:
            grp_key = lay.rsplit("/", 1)[0] if "/" in lay else lay
            if grp_key not in mha_groups:
                mha_groups[grp_key] = {}
                mha_order.append(grp_key)
            mha_groups[grp_key][part] = (kern, ws.get("bias:0"))
        elif kern is not None and kern.ndim == 4:
            bias = ws.get("bias:0")
            if bias is None:
                bias = np.zeros((kern.shape[2],), np.float32)
            deconvs.append((kern, bias))
        elif kern is not None and kern.ndim == 2:
            bias = ws.get("bias:0")
            dense2d.append((lay, kern, bias))
        elif "gamma:0" in ws:
            ln_pairs.append((ws["gamma:0"],
                             ws.get("beta:0",
                                    np.zeros_like(ws["gamma:0"]))))
        elif "embeddings:0" in ws:
            pos = ws["embeddings:0"]

    if pos is None:
        # Embedding tables may also save as a bias-free 2-D "kernel"
        for i, (lay, kern, bias) in enumerate(dense2d):
            if bias is None:
                pos = kern
                del dense2d[i]
                break
    if pos is None or not mha_groups:
        raise ValueError("keras ViT layout not recognised")

    embed_lay, embed_w, embed_b = dense2d[0]
    dim = embed_w.shape[1]
    patch_dim = embed_w.shape[0]
    in_ch = 4  # vitPose.py:106 num_input_channels
    p = int(round((patch_dim / in_ch) ** 0.5))
    assert in_ch * p * p == patch_dim, patch_dim

    depth = len(mha_order)
    ffs = dense2d[1:]
    if len(ffs) != 2 * depth or len(ln_pairs) != 2 * depth:
        raise ValueError(
            f"keras ViT: {depth} MHA layers but {len(ffs)} FFN denses / "
            f"{len(ln_pairs)} LayerNorms"
        )
    if len(deconvs) != 4:
        raise ValueError(f"keras ViT: expected 4 decoder deconvs, "
                         f"got {len(deconvs)}")

    q0 = mha_groups[mha_order[0]]["q"][0]  # (dim, H, Dh)
    heads, dim_head = int(q0.shape[1]), int(q0.shape[2])
    inner = heads * dim_head

    transformer: dict[str, Any] = {}
    for i, key in enumerate(mha_order):
        grp = mha_groups[key]
        # fused qkv in the (3, H, Dh) output layout
        qkv_kernel = np.concatenate(
            [grp[p_][0].reshape(dim, inner) for p_ in ("q", "k", "v")],
            axis=1,
        )
        qkv_bias = np.concatenate([
            (grp[p_][1] if grp[p_][1] is not None
             else np.zeros((heads, dim_head), np.float32)).reshape(-1)
            for p_ in ("q", "k", "v")
        ])
        o_w, o_b = grp["o"]  # (H, Dh, dim)
        transformer[f"attn{i}"] = {
            "to_qkv": {"kernel": np.ascontiguousarray(qkv_kernel),
                       "bias": qkv_bias.astype(np.float32)},
            "to_out": {"kernel": np.ascontiguousarray(
                           o_w.reshape(inner, dim)),
                       "bias": (o_b if o_b is not None
                                else np.zeros((dim,), np.float32))},
        }
        for half, (g, b) in (("a", ln_pairs[2 * i]),
                             ("b", ln_pairs[2 * i + 1])):
            transformer[f"postnorm{i}{half}"] = {"scale": g, "bias": b}
        (l1, k1, b1), (l2, k2, b2) = ffs[2 * i], ffs[2 * i + 1]
        transformer[f"ff{i}"] = {
            "fc1": {"kernel": np.ascontiguousarray(k1),
                    "bias": b1 if b1 is not None
                    else np.zeros((k1.shape[1],), np.float32)},
            "fc2": {"kernel": np.ascontiguousarray(k2),
                    "bias": b2 if b2 is not None
                    else np.zeros((k2.shape[1],), np.float32)},
        }

    patch_embed = {
        "proj": {"kernel": np.ascontiguousarray(
                     embed_w.reshape(p, p, in_ch, dim)),
                 "bias": embed_b if embed_b is not None
                 else np.zeros((dim,), np.float32)},
        "pos_embedding": np.ascontiguousarray(pos[None]),  # (1, N, dim)
    }
    decoder = {}
    for i, (kern, bias) in enumerate(deconvs, start=1):
        decoder[f"deconv{i}"] = {"kernel": _k_deconv(kern), "bias": bias}
    out_ch = deconvs[-1][0].shape[2]
    mlp_hidden = ffs[0][1].shape[1]
    arch = dict(
        out_channels=int(out_ch), patch_size=p, dim=int(dim),
        depth=depth, heads=heads, dim_head=dim_head,
        mlp_expand=int(round(mlp_hidden / dim)),
        kernel_size=int(deconvs[0][0].shape[0]), in_channels=in_ch,
    )
    return ImportedModel(
        params={"patch_embed": patch_embed, "transformer": transformer,
                "decoder": decoder},
        model_kind="vit", arch_flavor="tf", arch_kwargs=arch,
    )


def _import_keras_resnet(
    weights: list[tuple[str, np.ndarray]]
) -> ImportedModel:
    """``resnet50_encoder_shallow_decoder`` ``.h5``
    (tensorflow/Network.py:377-414): keras-applications ResNet50 v1 trunk +
    5 channel-halving Conv2DTranspose decoders.

    keras.applications names its resnet layers deterministically
    (``conv1_conv``, ``conv{s}_block{b}_{j}_conv`` / ``_bn``), so the trunk
    maps by NAME onto :class:`..models.resnet.KerasResNet50Encoder` (whose
    param tree uses the same keys); BN moving stats land in ``batch_stats``.
    The decoder's transposed convs are matched positionally (keras
    auto-names them), in save order.
    """
    import re

    lay_pat = re.compile(r"^(conv\d+_block\d+_\d+|conv1)_(conv|bn)$")
    enc_params: dict[str, Any] = {}
    enc_stats: dict[str, Any] = {}
    dec_layers: list[str] = []
    dec_parts: dict[str, dict[str, np.ndarray]] = {}
    block_ids: dict[int, set[int]] = {}

    for name, w in weights:
        parts = name.split("/")
        leaf = parts[-1].split(":")[0]
        lay = parts[-2] if len(parts) >= 2 else ""
        m = lay_pat.match(lay)
        if m:
            if m.group(2) == "conv":
                enc_params.setdefault(lay, {})[
                    "kernel" if leaf == "kernel" else "bias"] = w
            else:  # bn
                if leaf == "gamma":
                    enc_params.setdefault(lay, {})["scale"] = w
                elif leaf == "beta":
                    enc_params.setdefault(lay, {})["bias"] = w
                elif leaf == "moving_mean":
                    enc_stats.setdefault(lay, {})["mean"] = w
                elif leaf == "moving_variance":
                    enc_stats.setdefault(lay, {})["var"] = w
            bm = re.match(r"^conv(\d+)_block(\d+)_", lay)
            if bm:
                block_ids.setdefault(int(bm.group(1)), set()).add(
                    int(bm.group(2)))
        else:
            # decoder transposed convs (+ anything else weightful, which
            # the keras resnet graph does not contain)
            if lay not in dec_parts:
                dec_parts[lay] = {}
                dec_layers.append(lay)
            dec_parts[lay][leaf] = w

    deconvs = [(dec_parts[lay]["kernel"], dec_parts[lay].get("bias"))
               for lay in dec_layers
               if dec_parts[lay].get("kernel") is not None
               and dec_parts[lay]["kernel"].ndim == 4]
    if "conv1_conv" not in enc_params or len(deconvs) != 5:
        raise ValueError(
            f"keras resnet50 layout not recognised: stem "
            f"{'conv1_conv' in enc_params}, {len(deconvs)} decoder deconvs "
            "(expected 5 — tensorflow/Network.py:385-409)"
        )

    stem_k = enc_params["conv1_conv"]["kernel"]
    stage_sizes = [len(block_ids[s]) for s in sorted(block_ids)]
    params: dict[str, Any] = {"encoder": enc_params}
    names = ["deconv1", "deconv2", "deconv3", "deconv4", "head"]
    for tname, (kern, bias) in zip(names, deconvs):
        k = _k_deconv(kern)
        params[tname] = {
            "kernel": k,
            "bias": bias if bias is not None
            else np.zeros((k.shape[-1],), np.float32),
        }
    arch = dict(
        out_channels=int(deconvs[-1][0].shape[2]),
        kernel_size=int(deconvs[0][0].shape[0]),
        stem_features=int(stem_k.shape[-1]),
        stage_sizes=stage_sizes,
        in_channels=int(stem_k.shape[2]),
    )
    return ImportedModel(
        params=params, model_kind="resnet", arch_flavor="tf",
        arch_kwargs=arch, batch_stats={"encoder": enc_stats},
    )


def _parse_keras_cnn_stack(
    kernels: list[tuple[str, np.ndarray]], bias_for, nb: int
) -> dict[str, Any]:
    """Positional parse of ONE basic_nn enc-dec stack (6*nb+1 kernel/bias
    pairs in keras save order — tensorflow/Network.py:416-474) into the
    rebuild's TF-flavour EncoderAtrous/DecoderUp param tree."""
    params: dict[str, Any] = {"encoder": {}, "decoder": {}}
    idx = 0

    def take(tname: str, tree: dict, deconv: bool = False):
        nonlocal idx
        name, w = kernels[idx]
        idx += 1
        kern = _k_deconv(w) if deconv else w
        tree[tname] = {"kernel": np.ascontiguousarray(kern),
                       "bias": bias_for(name, kern.shape[-1])}

    for b in range(nb):
        for c in range(1, 4):
            take(f"block{b}_conv{c}", params["encoder"])
    for c in range(1, 4):
        take(f"bottleneck_conv{c}", params["encoder"])
    for b in range(nb - 1, 0, -1):
        take(f"block{b}_deconv", params["decoder"], deconv=True)
        take(f"block{b}_conv1", params["decoder"])
        take(f"block{b}_conv2", params["decoder"])
    take("head_deconv", params["decoder"], deconv=True)
    return params


def _try_import_keras_c2f(
    kernels: list[tuple[str, np.ndarray]], bias_for
) -> ImportedModel | None:
    """Recognise a ``C2F_per_wing`` save: frozen coarse basic_nn stack
    followed by the fine stack (tensorflow/Network.py:169-198).

    Split point: coarse is 6*nb1+1 kernels; the stitch is validated by the
    fine encoder's conv1 input width, which must equal the model input
    channels plus the coarse head's output channels (the reference
    concatenates x_in with the frozen coarse confmaps). The reference pins
    the coarse pyramid at nb=3 (Network.py:147), so that candidate is
    tried first.
    """
    n = len(kernels)
    cin = int(kernels[0][1].shape[2])
    for nb1 in (3, 2, 4, 1, 5):
        n1 = 6 * nb1 + 1
        n2 = n - n1
        if n2 < 7 or (n2 - 1) % 6:
            continue
        nb2 = (n2 - 1) // 6
        # coarse head is a Conv2DTranspose kernel (kh, kw, O, I)
        coarse_out = int(kernels[n1 - 1][1].shape[2])
        fine_in = int(kernels[n1][1].shape[2])
        if fine_in != cin + coarse_out:
            continue
        coarse = _parse_keras_cnn_stack(kernels[:n1], bias_for, nb1)
        fine = _parse_keras_cnn_stack(kernels[n1:], bias_for, nb2)
        arch = dict(
            out_channels=int(fine["decoder"]["head_deconv"]["kernel"]
                             .shape[-1]),
            coarse_out_channels=coarse_out,
            filters=int(kernels[n1][1].shape[-1]),
            coarse_filters=int(kernels[0][1].shape[-1]),
            kernel_size=int(kernels[0][1].shape[0]), dilation=2,
            num_blocks=nb2, coarse_num_blocks=nb1, in_channels=cin,
        )
        return ImportedModel(
            params={"coarse": coarse, "fine": fine},
            model_kind="c2f", arch_flavor="tf", arch_kwargs=arch,
        )
    return None


def import_keras_h5(path: str) -> ImportedModel:
    """Import a reference keras ``.h5`` CNN save (basic_nn family,
    tensorflow/Network.py:127-145 + 416-474).

    The reference never names its conv layers, so matching is positional:
    keras builds encoder convs (3 per block + 3 bottleneck), then decoder
    [deconv, conv, conv] per upsampling block and the linear head deconv —
    exactly the construction order of the TF-flavour
    EncoderAtrous/DecoderUp. Kernel/bias pairs are taken in save order and
    validated shape-by-shape against that structure.
    """
    weights = _keras_weight_list(path)
    if any(n.split("/")[-1].startswith("moving_mean") for n, _ in weights):
        # BatchNorm stats present: the keras ResNet50 family — the only TF
        # family with BN (tensorflow/Network.py:377-414)
        return _import_keras_resnet(weights)
    if any(w.ndim == 3 or "attention" in n.lower() for n, w in weights):
        # transformer weights present: the TF ViT save (vitPose.py)
        return import_keras_vit(weights)
    # conv-ish weights only: rank-4 kernels with their rank-1 biases
    kernels = [(n, w) for n, w in weights if w.ndim == 4]
    biases = {n.rsplit("/", 1)[0]: w for n, w in weights if w.ndim == 1}

    def bias_for(kname: str, out_dim: int) -> np.ndarray:
        b = biases.get(kname.rsplit("/", 1)[0])
        if b is None or b.shape[0] != out_dim:
            return np.zeros((out_dim,), np.float32)
        return b

    if not kernels:
        raise ValueError(f"no conv kernels found in {path}")

    filters = kernels[0][1].shape[-1]
    k_size = kernels[0][1].shape[0]
    # encoder depth: blocks of 3 convs doubling filters, then 3 bottleneck
    # convs at filters * 2^num_blocks — recover num_blocks by walking
    # until the filter count stops doubling per triple
    n = len(kernels)
    # total kernels = 3*nb + 3 (encoder) + 3*(nb-1) + 1 (decoder)
    # = 6*nb + 1  ->  nb = (n - 1) / 6
    if (n - 1) % 6:
        # Two stacked basic_nn stacks = a C2F_per_wing save (the frozen
        # coarse submodel's weights ride inside the .h5,
        # tensorflow/Network.py:169-198): n = (6*nb1+1) + (6*nb2+1), so
        # (n-1) % 6 == 1 always. Try that split before failing.
        c2f = _try_import_keras_c2f(kernels, bias_for)
        if c2f is not None:
            return c2f
        raise ValueError(
            f"{path}: {n} conv layers does not match the basic_nn family "
            "(expected 6*num_blocks + 1) nor a stacked C2F_per_wing save"
        )
    nb = (n - 1) // 6

    params = _parse_keras_cnn_stack(kernels, bias_for, nb)

    head_out = params["decoder"]["head_deconv"]["kernel"].shape[-1]
    enc_in = params["encoder"]["block0_conv1"]["kernel"].shape[2]
    enc_out = filters * 2 ** nb
    # The TF builders reuse the SAME nested encoder/decoder submodels for
    # every CNN wiring (basic_nn / two_wings_net / all_4_cams / all_3_cams
    # / head_tail_all_cams — tensorflow/Network.py:74-375), so the weight
    # sequence is identical; the WIRING is recovered from the first
    # decoder deconv's input width: enc_out x {1: basic, 2: two wings,
    # 1+N: shared-encoder N-camera fusion}.
    first_dec = (params["decoder"].get(f"block{nb - 1}_deconv")
                 or params["decoder"]["head_deconv"])
    ratio = first_dec["kernel"].shape[2] // enc_out
    base = dict(filters=int(filters), kernel_size=int(k_size), dilation=2,
                num_blocks=int(nb))
    if ratio == 1:
        arch = dict(out_channels=int(head_out), in_channels=int(enc_in),
                    **base)
        return ImportedModel(params=params, model_kind="basic_cnn",
                             arch_flavor="tf", arch_kwargs=arch)
    shared = {"shared_encoder": params["encoder"],
              "shared_decoder": params["decoder"]}
    if ratio == 2:
        # two_wings_net: views = time channels + one wing mask each
        arch = dict(out_channels=int(2 * head_out),
                    in_channels=int(enc_in + 1), **base)
        return ImportedModel(params=shared, model_kind="two_wings",
                             arch_flavor="tf", arch_kwargs=arch)
    if ratio in (4, 5):
        num_cams = ratio - 1
        arch = dict(out_channels=int(num_cams * head_out),
                    num_cams=num_cams, in_channels=int(num_cams * enc_in),
                    **base)
        return ImportedModel(params=shared, model_kind="multicam",
                             arch_flavor="tf", arch_kwargs=arch)
    raise ValueError(
        f"unrecognised keras CNN wiring: decoder input {ratio}x the "
        f"encoder latent width"
    )


# ---------------------------------------------------------------------------
# snapshots of imported checkpoints
# ---------------------------------------------------------------------------
IMPORT_SNAPSHOT_FORMAT = "imported_reference_v1"
# the JAX package's snapshot file magic (its snapshots are this, then flax
# msgpack); the port reads them, and writes its own as torch.save files
# carrying SNAPSHOT_MARKER
IMPORT_SNAPSHOT_MAGIC = b"#PEAT-IMPORT-SNAPSHOT:v1\n"
SNAPSHOT_MARKER = "pose-estimation-amitai-torch/imported-snapshot-v1"


def _first_msgpack_map_key(head: bytes) -> str | None:
    """Decode the first map key of a msgpack buffer, or ``None`` when the
    buffer does not start with a map whose first key is a short string
    (the JAX package's magic-less legacy snapshots start with "format")."""
    if not head:
        return None
    b0 = head[0]
    if 0x80 <= b0 <= 0x8F:          # fixmap
        i = 1
    elif b0 == 0xDE:                # map 16
        i = 3
    elif b0 == 0xDF:                # map 32
        i = 5
    else:
        return None
    if i >= len(head):
        return None
    k0 = head[i]
    if 0xA0 <= k0 <= 0xBF:          # fixstr
        n, j = k0 - 0xA0, i + 1
    elif k0 == 0xD9 and i + 1 < len(head):  # str 8
        n, j = head[i + 1], i + 2
    else:
        return None
    if j + n > len(head):
        return None
    return head[j:j + n].decode("utf-8", errors="replace")


def _to_tensors(tree):
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree.numpy() if torch.is_tensor(tree) else tree, np.float32)


def save_imported_snapshot(imported: ImportedModel, path: str) -> None:
    """Persist a converted reference checkpoint as one self-describing
    ``torch.save`` payload: :data:`SNAPSHOT_MARKER`, the params and BN
    running stats (flax-layout trees as float32 tensors) and the
    architecture (model_kind / arch_flavor / arch_kwargs, with the fidelity
    flags ref_token_grid / ref_ftl_layout / dilation), so that
    ``Predictor.from_checkpoint`` rebuilds the exact module without the
    reference file or the config."""
    payload = {
        "marker": SNAPSHOT_MARKER,
        "format": IMPORT_SNAPSHOT_FORMAT,
        "params": _to_tensors(imported.params),
        "batch_stats": _to_tensors(imported.batch_stats or {}),
        "meta": json.dumps({
            "model_kind": imported.model_kind,
            "arch_flavor": imported.arch_flavor,
            "arch_kwargs": imported.arch_kwargs,
        }),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _from_payload(restored) -> ImportedModel | None:
    if not (isinstance(restored, dict)
            and restored.get("format") == IMPORT_SNAPSHOT_FORMAT):
        return None
    meta = json.loads(restored["meta"])
    return ImportedModel(
        params=_to_numpy(restored["params"]),
        model_kind=meta["model_kind"],
        arch_flavor=meta["arch_flavor"],
        arch_kwargs=meta["arch_kwargs"],
        batch_stats=_to_numpy(restored.get("batch_stats") or {}) or None,
    )


def load_imported_snapshot(path: str) -> ImportedModel | None:
    """Load a snapshot of an imported checkpoint: the port's
    (:func:`save_imported_snapshot`) or the JAX package's (its magic, or a
    legacy magic-less payload whose first msgpack key is "format", read
    with ``msgpack`` and no jax). ``None`` when ``path`` is neither (a run
    directory, another checkpoint, a reference file), decided from the
    file's first bytes and, for a ``torch.save`` archive, its marker."""
    if not os.path.isfile(path):
        return None
    if archive_kind(path) == "torch_save":
        payload = _torch_payload(path)
        if not (isinstance(payload, dict) and payload.get("marker") == SNAPSHOT_MARKER):
            return None
        return _from_payload(payload)
    with open(path, "rb") as f:
        head = f.read(64)
        if head.startswith(IMPORT_SNAPSHOT_MAGIC):
            f.seek(len(IMPORT_SNAPSHOT_MAGIC))
        elif _first_msgpack_map_key(head) == "format":
            f.seek(0)
        else:
            return None
        blob = f.read()
    from .weights import unpack_flax_msgpack

    return _from_payload(unpack_flax_msgpack(blob))


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------
def import_reference_checkpoint(
    path: str, dim_head: int | None = None
) -> ImportedModel:
    """Auto-detecting importer: keras ``.h5`` (by the HDF5 signature) vs
    torch ``.pth``/``.pt`` archives.

    ``dim_head``: explicit head-split override for torch ViT checkpoints
    whose (heads, dim_head) factorisation is shape-ambiguous.
    """
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path}: no such checkpoint file")
    if is_hdf5(path):
        return import_keras_h5(path)
    return import_torch_checkpoint(path, dim_head=dim_head)
