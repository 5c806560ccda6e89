"""Whole movies of 4-camera samples, each with its own cameras, through
``Predictor.predict_movie``, back to back.

The movie is ``movie_frames`` distinct uniform float32 samples in pageable
host memory, the four views' channels side by side, and its cameras: a
fixed ring of four K[R|t] cameras drawn from the seed, each sample and view
cropped at its own origin, uniform over the sensor; from those the
crop-adjusted P at unit Frobenius norm and its float64 pseudo-inverse at
unit norm (pytorch/Datagenerators.py:382-413), as the port's data pipeline
makes them for a box. The ``Predictor`` takes the cameras through its
public constructor, one row per sample, and is held to the cell's route.
``correct``: the samples of ``check_chunks`` chunks drawn from the seed are
run through the plain reference, with the same camera rows, once the window
has closed, and every call's peaks of those samples, over all the views'
channels, are read against it.
"""

from __future__ import annotations

import gc

import numpy as np
import torch
from torch.autograd.profiler import record_function

from .. import compare, program
from ..serving import argmax_peaks, exact_float32
from ..weights import SAMPLE, make_tree, seed_stream, uniform_frames

CAMERAS = 6  # the seed's stream for the rig and the crops
SENSOR = (800, 1280)  # rows, columns
# a high-speed rig's geometry: 28-um pixels behind a 105-mm macro lens at
# about 1:1, the world in millimetres (a wing of 2.5 mm spans about 90 px)
FOCAL_PX = 7500.0  # focal length in pixels
DISTANCE = 210.0  # from each camera to the origin, mm
REF_BLOCK = 32  # samples a reference forward takes at once


def ring_cameras(rng: np.random.Generator, views: int = 4) -> np.ndarray:
    """``views`` cameras K[R|t] ringed around the origin, (views, 3, 4),
    float64: focal lengths about ``FOCAL_PX``, the principal point at the
    sensor's centre, each ``DISTANCE`` from the origin looking at it from
    its own side, about 30 degrees from above."""
    cams = []
    for v in range(views):
        f = FOCAL_PX * (1.0 + rng.uniform(-0.035, 0.035))
        K = np.array([[f, 0.0, SENSOR[1] / 2], [0.0, f, SENSOR[0] / 2], [0.0, 0.0, 1.0]])
        theta = v * 2 * np.pi / views + rng.uniform(-0.2, 0.2)
        phi = 0.5 + rng.uniform(-0.1, 0.1)
        c, s = np.cos(theta), np.sin(theta)
        Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        c, s = np.cos(phi), np.sin(phi)
        Rx = np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])
        t = np.array([[0.0], [0.0], [DISTANCE * (1.0 + rng.uniform(-0.03, 0.03))]])
        cams.append(K @ np.hstack([Rx @ Rz, t]))
    return np.stack(cams)


def crop_cameras(cams: np.ndarray, crops: np.ndarray, crop: int) -> tuple[np.ndarray, ...]:
    """(views, 3, 4) cameras and (n, views, 2) [y, x] crop origins -> the
    crop-adjusted (n, views, 3, 4) P and (n, views, 4, 3) P_inv, float32:
    K normalised by K[2, 2] (here 1), its principal point moved to the
    crop's frame (x - x_crop, rows counted up from the crop's bottom), P
    and its float64 pseudo-inverse each at unit Frobenius norm."""
    shift = np.zeros((*crops.shape[:2], 3, 4))
    shift[..., 0, :] = crops[..., 1, None] * cams[None, :, 2, :]
    shift[..., 1, :] = (SENSOR[0] + 1 - crops[..., 0, None] - crop) * cams[None, :, 2, :]
    # (K - S) [R | t] = K [R | t] - S [R | t], S's only entries in column 2
    P = cams[None] - shift
    P /= np.linalg.norm(P, axis=(-2, -1), keepdims=True)
    P_inv = np.linalg.pinv(P)
    P_inv /= np.linalg.norm(P_inv, axis=(-2, -1), keepdims=True)
    return P.astype(np.float32), P_inv.astype(np.float32)


def camera_rows(n: int, seed: int, crop: int, views: int = 4) -> tuple[np.ndarray, ...]:
    """The movie's (P, P_inv) rows, drawn from ``seed``."""
    rng = np.random.default_rng(seed_stream(seed, CAMERAS))
    cams = ring_cameras(rng, views)
    crops = np.stack([rng.integers(0, SENSOR[0] - crop, (n, views), endpoint=True),
                      rng.integers(0, SENSOR[1] - crop, (n, views), endpoint=True)], -1)
    return crop_cameras(cams, crops.astype(np.float64), crop)


def predictor(spec: dict, params: dict, stats: dict, cameras, device: torch.device):
    """The port's ``Predictor`` of this configuration on its route, built
    from the flax-layout variables with the movie's cameras."""
    from pose_estimation_amitai_torch.infer import Predictor

    pred = Predictor(
        program.port_config(spec), params, tuple(spec["image_shape"]), spec["out_channels"],
        device=device, chunk_size=spec["chunk_size"], use_fused=spec["route"] == "fused",
        decode=spec["decode"], batch_stats=stats, cameras=cameras)
    if pred.serving_path != spec["route"]:
        raise RuntimeError(f"asked for route {spec['route']!r}, the port serves "
                           f"{pred.serving_path!r}")
    return pred


class Driver:
    def __init__(self, ctx):
        t, spec = ctx.traffic, ctx.spec
        self.ctx = ctx
        self.chunk = spec["chunk_size"]
        self.prefetch = t["prefetch"]
        self.cameras = camera_rows(t["movie_frames"], ctx.seed, spec["image_shape"][0])
        tree, self.ref_params = make_tree(ctx.family.leaves(spec), ctx.seed, ctx.device)
        self.pred = predictor(spec, *ctx.family.split_tree(tree), self.cameras, ctx.device)
        self.movie = uniform_frames(t["movie_frames"], tuple(spec["image_shape"]), ctx.seed,
                                    ctx.device)
        # warm-up: the window's only shape is a whole chunk
        self.pred.predict_movie(self.movie[: t["warmup_frames"]], prefetch=self.prefetch)
        self.outputs: list[np.ndarray] = []

    def unit(self) -> int:
        with record_function("portbench.predict_movie"):
            out = self.pred.predict_movie(self.movie, prefetch=self.prefetch)
        self.outputs.append(out)
        return out.shape[0]

    def sync(self) -> None:
        """``predict_movie`` returns host arrays: nothing is left in flight."""

    def end_to_end(self, window_s: float, useful: int) -> dict:
        return {"serve_fps": useful / window_s}

    def work(self) -> dict:
        spec, fam = self.ctx.spec, self.ctx.family
        return {"kind": "serve", "flops_per_useful": fam.flops_per_frame(spec),
                "kernel_bounds": fam.kernel_bounds(spec, self.chunk)}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.pred = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _rows(self) -> np.ndarray:
        cs = self.chunk
        n_chunks = self.movie.shape[0] // cs
        rng = np.random.default_rng(seed_stream(self.ctx.seed, SAMPLE))
        pick = np.sort(rng.choice(n_chunks, self.ctx.traffic["check_chunks"], replace=False))
        return np.concatenate([np.arange(c * cs, (c + 1) * cs) for c in pick])

    def _reference(self, rows: np.ndarray, quant=lambda t: t) -> torch.Tensor:
        dev = self.ctx.device
        x = torch.from_numpy(np.ascontiguousarray(self.movie[rows])).to(dev)
        P, P_inv = (torch.from_numpy(c[rows]).to(dev) for c in self.cameras)
        with torch.no_grad(), exact_float32():
            return self.ctx.family.forward(self.ref_params, x, self.ctx.spec, quant, P, P_inv)

    def numbers(self) -> dict:
        """The worst reading over every call's answer for the checked rows."""
        rows, readings = self._rows(), []
        for i in range(0, len(rows), REF_BLOCK):
            block = rows[i : i + REF_BLOCK]
            ref = self._reference(block)
            readings += [compare.peak_numbers(ref, o[block], self.ctx.family.VAL_MODE)
                         for o in self.outputs]
        return compare.worst(*readings)

    def control_numbers(self) -> dict:
        """The reference computed in fp8 in the program's place, its argmax
        peaks read in the float32 reference's maps."""
        rows, readings = self._rows(), []
        for i in range(0, len(rows), REF_BLOCK):
            block = rows[i : i + REF_BLOCK]
            ref = self._reference(block)
            ctl = argmax_peaks(self._reference(block, compare.fp8))
            readings.append(compare.peak_numbers(ref, ctl, self.ctx.family.VAL_MODE))
        return compare.worst(*readings)
