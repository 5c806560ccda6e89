"""Deployable serving artifacts: an exported ``torch.export`` program with
its weights (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/deploy.py``. The reference's
deployable is a TorchScript ``best_model.pth`` (pytorch/train_pytorch.py:
177-181); the JAX package serializes its ``Predictor``'s jitted ``frames ->
peaks`` program with ``jax.export``. The port exports the same chunk
program -- the serving route's forward and the peak decode on the device,
the weights held in the program -- with ``torch.export``, for every route
the port's ``Predictor`` serves: ``module``, ``fused``, ``int8_resident``,
``int8_fused``, ``int8_generic`` and the ViT's ``fused``. The hand-written
kernels of the fused routes are custom ops (ops/custom_ops.py), so they stay
one node each in the exported graph, and a loaded program launches them.

File format: the ``PEATORCH`` magic, a 4-byte little-endian JSON header
length, the JSON header (the JAX header's fields, with ``device_type`` in
place of ``platforms``, plus the serving path and decode), then the
``torch.export.save`` bytes.

A program is loaded on the device type it was exported on, and only
there: its weights and the devices in its graph are that device's, and
:func:`load_exported` refuses another (``ValueError``) rather than moving
the program behind the caller's back. The camera-matrix families (whose
forward takes per-sample cameras) and ``return_heatmaps`` predictors are
refused, as in JAX.

Usage::

    python -m pose_estimation_amitai_torch export cfg.json ckpt model.ptexp
    ...
    from pose_estimation_amitai_torch.deploy import load_exported
    predictor = load_exported("model.ptexp", "cuda")
    peaks = predictor(frames)            # (N, 3, K), any N -- chunked + padded
"""

from __future__ import annotations

import io
import json
import os
import struct

import numpy as np
import torch
from torch import nn

from .infer import FrameStager

MAGIC = b"PEATORCH"
FORMAT = "pose-estimation-amitai-torch/exported-predictor"


class _ChunkProgram(nn.Module):
    """A predictor's chunk program as a module: (chunk, H, W, C) float32
    frames on its device -> (chunk, 3, K) float32 peaks. The module route's
    ``nn.Module`` is a submodule, so its weights are the program's
    parameters; the other routes' weights are tensors of their closures,
    which the export lifts as constants."""

    def __init__(self, predictor):
        super().__init__()
        self.model = predictor.model
        self._run = predictor._run

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        return self._run(frames)


def export_predictor(predictor, path: str) -> dict:
    """Serialize ``predictor``'s chunk program (weights in it) to ``path``
    for the device type it serves on; returns the header."""
    if predictor.return_heatmaps:
        raise ValueError(
            "export serves the peaks program; build the Predictor with "
            "return_heatmaps=False")
    if predictor._needs_cams:
        raise ValueError(
            f"{predictor.cfg.model_type} takes per-sample camera matrices "
            "(x, P, P_inv); the exported artifact serves a frames-only "
            "program -- serve this family through infer.Predictor instead")
    cs = predictor.chunk_size
    frames = torch.zeros((cs, *predictor.image_shape), dtype=torch.float32,
                         device=predictor.device)
    program = torch.export.export(_ChunkProgram(predictor), (frames,), strict=False)
    # the example chunk (151 MB of zeros at 256 x 192 x 192 x 4) would be
    # saved with the program; the header keeps its shape
    program.example_inputs = None
    header = {
        "format": FORMAT,
        "chunk_size": int(cs),
        "image_shape": [int(v) for v in predictor.image_shape],
        "model_type": predictor.cfg.model_type,
        "device_type": predictor.device.type,
        "serving_path": predictor.serving_path,
        "decode": predictor.decode,
        "out_shape": [int(cs), 3, int(predictor.num_output_channels)],
        "torch": torch.__version__,
    }
    buf = io.BytesIO()
    torch.export.save(program, buf)
    hdr = json.dumps(header).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        f.write(buf.getvalue())
    os.replace(tmp, path)
    return header


class ExportedPredictor:
    """Chunked inference driver around a loaded program.

    Mirrors ``Predictor.__call__``'s contract: (N, H, W, C) frames for any N
    -> (N, 3, K) [x, y, val] float32 numpy peaks; the tail chunk is
    zero-padded to the artifact's static chunk size and its padded rows
    dropped; an empty movie gives (0, 3, K)."""

    def __init__(self, program, header: dict, device: torch.device):
        self.header = header
        self.device = device
        self.chunk_size = int(header["chunk_size"])
        self.image_shape = tuple(header["image_shape"])
        self.module = program.module()
        self._stager = FrameStager(device, self.chunk_size)

    def _stage(self, chunk) -> torch.Tensor:
        """One chunk as float32 (JAX's ``np.asarray(..., np.float32)``) on
        the device through the Predictor's stager, zero-padded."""
        return self._stager(np.asarray(chunk, np.float32))

    def __call__(self, frames) -> np.ndarray:
        n = frames.shape[0]
        cs = self.chunk_size
        if tuple(frames.shape[1:]) != self.image_shape:
            raise ValueError(f"frames {tuple(frames.shape[1:])} != exported {self.image_shape}")
        outs = []
        with torch.inference_mode():
            for i in range(0, n, cs):
                keep = min(cs, n - i)
                outs.append(self.module(self._stage(frames[i : i + cs]))[:keep].cpu().numpy())
        if outs:
            return np.concatenate(outs)
        # empty input: keep the exported output's rank and K, so callers can
        # concatenate per-segment results
        return np.zeros((0, *self.header["out_shape"][1:]), np.float32)


def read_artifact(path: str) -> tuple[dict, bytes]:
    """(header, program bytes) of an artifact; ``ValueError`` for a file
    that does not start with :data:`MAGIC` (the JAX package's artifacts
    start with ``PEATPU01``)."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path}: not an exported-predictor artifact of the port "
                             f"(magic {magic!r})")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode())
        return header, f.read()


def load_exported(path: str, device: torch.device | str) -> ExportedPredictor:
    """Load an artifact written by :func:`export_predictor` to run on
    ``device``, which must be of the device type it was exported on
    (``ValueError`` otherwise). Importing the ops module first registers the
    custom ops, so the program's kernel nodes launch the same kernels."""
    from .ops import custom_ops  # noqa: F401 (registers the ops the graph names)

    device = torch.device(device)
    header, blob = read_artifact(path)
    if header["device_type"] != device.type:
        raise ValueError(
            f"{path} was exported for {header['device_type']!r}; it loads on that "
            f"device type only, not on {device.type!r} (export it again there)")
    program = torch.export.load(io.BytesIO(blob))
    return ExportedPredictor(program, header, device)
