"""Device-resident training data (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/data/pipeline.py`` (reference:
pytorch/Datagenerators.py:17-115 ``DataGenerator``, its shuffled index ring
at :39-65; tensorflow/simple_data_generator.py:31-70). The dataset is small
(hundreds to thousands of 192x192 samples), so it lives on the device whole;
the host only makes index arrays, and the train step gathers, augments and
renders targets on the device. The split and the epoch ring come from the
same numpy generator as JAX's, so both packages draw the same indices.

For the disentangled camera-matrix models the per-sample crop-adjusted
cameras (reference: pytorch/Datagenerators.py:228-270, 382-413), or with
``estimate_cameras`` per-frame DLT fits to the decoded targets
(tensorflow/Custom_data_generator.py:216-241), are computed once on the
host and ride beside the frames as ``P`` (N, 4, 3, 4) and ``P_inv`` (N, 4,
4, 3); both wings of a frame become samples, where the reference draws one
at random (:257-260).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from .. import constants as C
from ..config import Config
from ..ops import geometry
from ..ops import peaks as peaks_ops
from .preprocess import Preprocessor, find_peaks_np

CAMERA_KEYS = ("P", "P_inv")  # the disentangled models' per-sample cameras

DECODE_CHUNK = 512  # frames a decode of the targets' peaks takes at once


class DeviceDataset:
    """Arrays on ``device`` + host-side epoch index generation.

    Split: one shuffled permutation, the first ``val_fraction`` to
    validation (pytorch/Datagenerators.py:109-115); the epoch batch ring
    wraps around to keep the batch size (:39-65). ``peaks`` / ``peak_vals``
    (the sub-pixel decode of the target maps, ``find_peaks_refined``) are
    added where ``confmaps`` come without them: the train step re-renders
    targets from them.
    """

    _device_resident = True

    def __init__(
        self,
        cfg: Config,
        data: dict[str, np.ndarray],
        seed: int | None = None,
        *,
        device: torch.device | str,
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.rng = np.random.default_rng(cfg.seed if seed is None else seed)
        n = data["box"].shape[0]
        order = self.rng.permutation(n)
        val_size = round(n * cfg.val_fraction)
        self.val_inds = order[:val_size]
        self.train_inds = order[val_size:]
        self.data = {k: self._place(torch.as_tensor(np.asarray(v)))
                     for k, v in data.items()}
        if "confmaps" in self.data and "peaks" not in self.data:
            pvs = [
                peaks_ops.find_peaks_refined(
                    self.data["confmaps"][i : i + DECODE_CHUNK].to(self.device))
                for i in range(0, n, DECODE_CHUNK)
            ]
            pv = torch.cat(pvs)  # (N, 3, K)
            self.data["peaks"] = self._place(pv[:, :2, :].transpose(1, 2).contiguous())
            self.data["peak_vals"] = self._place(pv[:, 2, :].contiguous())
        self.num_samples = n
        self._epoch_order = self.train_inds.copy()
        self._cursor = 0

    def _place(self, t: torch.Tensor) -> torch.Tensor:
        """Where this dataset keeps its arrays: on the device."""
        return t.to(self.device)

    # -- reference-parity epoch iteration ------------------------------------
    def shuffle_train_indices(self) -> None:
        self.rng.shuffle(self._epoch_order)
        self._cursor = 0

    def next_batch_indices(self, batch_size: int) -> np.ndarray:
        """Wrap-around batch ring (pytorch/Datagenerators.py:43-65)."""
        if len(self._epoch_order) == 0:
            raise ValueError(
                "empty train split: val_fraction leaves no training "
                "samples (the wrap-around ring would spin forever)"
            )
        out: list[int] = []
        while len(out) < batch_size:
            take = min(batch_size - len(out), len(self._epoch_order) - self._cursor)
            out.extend(self._epoch_order[self._cursor : self._cursor + take])
            self._cursor += take
            if self._cursor >= len(self._epoch_order):
                self._cursor = 0
        return np.asarray(out[:batch_size], np.int32)

    def step_indices(self, batch_size: int, accum_steps: int) -> np.ndarray:
        """(accum_steps, batch_size) indices for one optimiser step."""
        return np.stack(
            [self.next_batch_indices(batch_size) for _ in range(accum_steps)]
        )

    def val_batches(self, batch_size: int) -> Iterator[tuple[np.ndarray, int]]:
        """Full-coverage validation index batches and their sizes."""
        inds = self.val_inds
        for i in range(0, len(inds), batch_size):
            chunk = inds[i : i + batch_size]
            yield np.asarray(chunk, np.int32), len(chunk)

    def val_payloads(self, batch_size: int) -> Iterator[tuple[dict, int]]:
        """Validation batches ``({"image", "confmaps"[, "P", "P_inv"]}, n)``
        on the device. The split is static, so it is gathered once and
        sliced per call."""
        if not hasattr(self, "_val_cache"):
            self._val_cache = self._take(self.val_inds)
        n = len(self.val_inds)
        for i in range(0, n, batch_size):
            stop = min(i + batch_size, n)
            yield ({k: v[i:stop].to(self.device) for k, v in self._val_cache.items()},
                   stop - i)

    def _take(self, ids) -> dict[str, torch.Tensor]:
        ids = torch.as_tensor(np.asarray(ids), device=self.data["box"].device)
        out = {"image": self.data["box"][ids], "confmaps": self.data["confmaps"][ids]}
        out.update({k: self.data[k][ids] for k in CAMERA_KEYS if k in self.data})
        return out

    def gather(self, ids) -> dict[str, torch.Tensor]:
        """``{"image", "confmaps"}`` (and the cameras ``P``, ``P_inv``) of
        samples ``ids``, on the device."""
        return {k: v.to(self.device) for k, v in self._take(ids).items()}

    # -- train-step feeds ----------------------------------------------------
    def step_payload(self, idx: np.ndarray) -> tuple[dict, torch.Tensor]:
        """``(data, idx)`` for the train step: the whole device-resident
        dict and the global (accum, B) indices, gathered inside the step."""
        return self.data, torch.as_tensor(idx, device=self.device)

    def microbatch_arrays(self, idx: np.ndarray) -> dict[str, torch.Tensor]:
        """(accum, B, ...) gathered tensors on the device for the
        data-parallel step (parallel/sharded.py): ``image``, ``confmaps``
        and, where the dataset has them, the cameras, ``peaks`` and
        ``peak_vals``."""
        ids = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=self.data["box"].device)
        batch = {"image": self.data["box"][ids], "confmaps": self.data["confmaps"][ids]}
        batch.update({k: self.data[k][ids] for k in (*CAMERA_KEYS, "peaks", "peak_vals")
                      if k in self.data})
        return {k: v.to(self.device) for k, v in batch.items()}


class HostDataset(DeviceDataset):
    """Host-memory variant for datasets above the device budget (100k
    frames of 192x192x22 float32 are about 32 GB). Each step gathers its
    (accum * B) window on the host and copies it to the device; targets
    still re-render there from the peaks, so the (B, H, W, K) maps never
    cross. Chosen by ``Config.host_resident_data`` or by
    ``Config.device_dataset_budget_mb`` (build_dataset)."""

    _device_resident = False

    def _place(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu()

    def step_payload(self, idx: np.ndarray) -> tuple[dict, torch.Tensor]:
        flat = torch.as_tensor(np.asarray(idx).reshape(-1), dtype=torch.long)
        window = {k: self.data[k][flat].to(self.device)
                  for k in ("box", "peaks", "peak_vals", *CAMERA_KEYS) if k in self.data}
        if "peaks" not in self.data:
            window["confmaps"] = self.data["confmaps"][flat].to(self.device)
        local = torch.arange(flat.numel(), dtype=torch.int32).reshape(idx.shape)
        return window, local.to(self.device)


def _camera_matrix_arrays(pre: Preprocessor) -> tuple[np.ndarray, np.ndarray]:
    """Per-frame crop-adjusted (P, P_inv) (F, 4, 3, 4) / (F, 4, 4, 3) of
    the disentangled models (``CameraMatrixGenerator``,
    pytorch/Datagenerators.py:382-413): each DLT camera decomposed once,
    its principal point shifted by each frame's cropZone; the crop size is
    the maps' (``confmaps_orig``)."""
    Ks, Rs, ts = geometry.decompose_camera(torch.from_numpy(pre.camera_matrices))
    P, P_inv = geometry.crop_adjusted_matrices(
        Ks, Rs, ts, torch.as_tensor(np.asarray(pre.cropzone), dtype=torch.float32),
        crop_size=int(pre.get_confmaps_orig().shape[2]))
    return P.numpy(), P_inv.numpy()


def estimate_cameras_from_peaks(
    confmaps: np.ndarray, cropzone: np.ndarray, points_3d: np.ndarray,
    crop_local: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-frame, per-camera DLT cameras fitted to the decoded target peaks
    (the TF ``CustomDataGenerator`` camera mode,
    tensorflow/Custom_data_generator.py:216-241), and their numpy
    pseudo-inverses.

    Peaks clipped at the crop's border are dropped, unless fewer than 6
    (the DLT's least) would remain; then all are used. The DLT's SVD runs
    in float64 (the cameras are stored as float32): the system mixes
    millimetre 3D points with pixel coordinates, and a float32 null vector
    (JAX's) reprojects up to about a pixel from the exact fit on the
    crop-local peaks, and further on the full-sensor ones. ``crop_local``: fit
    the crop-local peaks in the flipped frame ``(x, H - y)`` that
    :func:`..ops.geometry.crop_adjusted_matrices` gives (the reference's
    convention; the crop offset lands in each frame's P); default: the
    full-sensor coordinates.

    Args:
      confmaps: (F, cams, H, W, K) maps whose channels match ``points_3d``;
        cropzone: (F, cams, 2); points_3d: (F, K, 3).

    Returns (F, cams, 3, 4) cameras and (F, cams, 4, 3) pseudo-inverses.
    """
    frames, ncams = confmaps.shape[:2]
    peaks2d = find_peaks_np(confmaps.reshape((-1,) + confmaps.shape[2:]))[:, :2, :]
    peaks2d = np.transpose(peaks2d.reshape(frames, ncams, 2, -1), (0, 1, 3, 2))
    k = min(points_3d.shape[1], peaks2d.shape[2])
    h, w = confmaps.shape[2:4]
    if crop_local:
        full = peaks2d[:, :, :k].astype(np.float32)
        full = np.stack([full[..., 0], h - full[..., 1]], axis=-1)
    else:
        full = geometry.uncrop_points(
            torch.as_tensor(peaks2d[:, :, :k], dtype=torch.float32),
            torch.as_tensor(np.asarray(cropzone), dtype=torch.float32)).numpy()
    P = np.zeros((frames, ncams, 3, 4), np.float32)
    P_inv = np.zeros((frames, ncams, 4, 3), np.float32)
    for f in range(frames):
        for c in range(ncams):
            local = peaks2d[f, c, :k]
            ok = ((local[:, 0] > 0) & (local[:, 0] < w - 1)
                  & (local[:, 1] > 0) & (local[:, 1] < h - 1))
            if ok.sum() < 6:
                ok = np.ones(k, bool)
            P[f, c] = geometry.estimate_projection_dlt(
                torch.as_tensor(points_3d[f, :k][ok], dtype=torch.float64),
                torch.as_tensor(full[f, c][ok], dtype=torch.float64)).numpy()
            P_inv[f, c] = np.linalg.pinv(P[f, c])
    return P, P_inv


def _assemble_disentangled(pre: Preprocessor) -> tuple[np.ndarray, np.ndarray]:
    """(2F, H, W, 16) frames and (2F, H, W, 4 (half + 2)) maps of the
    disentangled models (``CameraMatrixGenerator.__getitem__``,
    pytorch/Datagenerators.py:242-280): per wing, each camera gives its time
    channels and that wing's mask, and that wing's map channels plus head
    and tail; the four cameras side by side on the channels; the left wings'
    samples first, then the right's."""
    box_orig = pre.get_box_orig()  # (F, cams, H, W, T + 2)
    cm_orig = pre.get_confmaps_orig()  # (F, cams, H, W, 2 half + 2)
    ncams, t = box_orig.shape[1], pre.num_time_channels
    head_tail = cm_orig[..., -2:]
    left_cm, right_cm = np.array_split(cm_orig[..., :-2], 2, axis=-1)
    left_cm = np.concatenate([left_cm, head_tail], axis=-1)
    right_cm = np.concatenate([right_cm, head_tail], axis=-1)
    left_box = box_orig[..., list(range(t)) + [t]]
    right_box = box_orig[..., list(range(t)) + [t + 1]]

    def cams_to_channels(x):  # (F, cams, H, W, c) -> (F, H, W, cams * c)
        return np.concatenate([x[:, c] for c in range(ncams)], axis=-1)

    box = np.concatenate([cams_to_channels(left_box), cams_to_channels(right_box)])
    confmaps = np.concatenate([cams_to_channels(left_cm), cams_to_channels(right_cm)])
    return box.astype(np.float32), confmaps.astype(np.float32)


def disentangled_samples(
    cfg: Config, pre: Preprocessor
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(frames, maps, P, P_inv) of a preprocessed disentangled dataset: the
    two wing samples of each frame (:func:`_assemble_disentangled`) and
    their cameras, decomposed from the DLT cameras or, with
    ``cfg.estimate_cameras``, fitted to the decoded targets in the crop's
    frame (the 3D points reordered to ``confmaps_orig``'s channels, whose
    wing blocks come right-index first)."""
    box, confmaps = _assemble_disentangled(pre)
    if cfg.estimate_cameras:
        pts = pre.points_3d
        order = np.concatenate([pre.right_inds, pre.left_inds,
                                [pts.shape[1] - 2, pts.shape[1] - 1]])
        P, P_inv = estimate_cameras_from_peaks(
            pre.get_confmaps_orig(), pre.cropzone, pts[:, order], crop_local=True)
    else:
        P, P_inv = _camera_matrix_arrays(pre)
    return box, confmaps, np.concatenate([P, P]), np.concatenate([P_inv, P_inv])


def build_dataset(
    cfg: Config,
    arrays: dict[str, np.ndarray] | None = None,
    preprocessor: Preprocessor | None = None,
    *,
    device: torch.device | str,
) -> tuple[DeviceDataset, Preprocessor]:
    """Preprocess (``cfg.data_path``'s H5 file, or ``arrays``) and stage
    the samples on ``device``; the disentangled types' with their cameras
    (:func:`disentangled_samples`)."""
    pre = preprocessor or Preprocessor(cfg, arrays)
    pre.do_preprocess()
    if cfg.model_type in (C.ALL_CAMS_DISENTANGLED_PER_WING_CNN,
                          C.ALL_CAMS_DISENTANGLED_PER_WING_VIT):
        box, confmaps, P, P_inv = disentangled_samples(cfg, pre)
        data = {"box": box, "confmaps": confmaps, "P": P, "P_inv": P_inv}
    else:
        data = {"box": pre.get_box(), "confmaps": pre.get_confmaps()}
    nbytes = sum(np.asarray(v).nbytes for v in data.values())
    use_host = cfg.host_resident_data or (
        nbytes > cfg.device_dataset_budget_mb * 2**20
    )
    cls = HostDataset if use_host else DeviceDataset
    return cls(cfg, data, device=device), pre
