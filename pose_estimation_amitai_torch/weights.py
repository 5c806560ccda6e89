"""Weight bridge: flax ``BasicNet`` params -> the port's tensors.

Input everywhere is a flax ``params`` tree as nested dicts of arrays
(anything ``np.asarray`` takes), the layout the JAX package trains and
checkpoints. Two outputs:

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

:func:`load_flax_checkpoint` reads what ``train/checkpoint.py`` writes
(flax msgpack) with a lazy ``import msgpack`` and no jax;
:func:`init_basicnet_params` makes a seeded flax-layout tree with numpy.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

# flax msgpack ext type ids (flax/serialization.py _MsgpackExtType)
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def conv_kernel_to_torch(k_hwio: Any) -> torch.Tensor:
    """flax Conv kernel (kh, kw, I, O) -> torch Conv2d weight (O, I, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(k_hwio, np.float32), (3, 2, 0, 1))
    ))


def deconv_kernel_to_torch(k_hwio: Any) -> torch.Tensor:
    """flax ConvTranspose kernel (kh, kw, I, O) -> torch ConvTranspose2d
    weight (I, O, kh, kw), flipped in space."""
    k = np.asarray(k_hwio, np.float32)[::-1, ::-1]
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1))))


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
    rng). ``batch_stats`` is ``{}`` where there are none. Leaves are numpy
    arrays; nothing of jax is imported. (Snapshots of imported reference
    checkpoints are ROADMAP Queue A item 13.)"""
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    batch_stats: dict = {}
    if isinstance(tree, dict) and {"params", "opt_state"} <= set(tree):
        batch_stats = tree.get("batch_stats") or {}
        tree = tree["params"]
    return tree, batch_stats
