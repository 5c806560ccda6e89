"""Device-resident training data (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/data/pipeline.py`` (reference:
pytorch/Datagenerators.py:17-115 ``DataGenerator``, its shuffled index ring
at :39-65; tensorflow/simple_data_generator.py:31-70). The dataset is small
(hundreds to thousands of 192x192 samples), so it lives on the device whole;
the host only makes index arrays, and the train step gathers, augments and
renders targets on the device. The split and the epoch ring come from the
same numpy generator as JAX's, so both packages draw the same indices.

Not ported here: the camera-matrix arrays of the disentangled models and
``estimate_cameras`` (ROADMAP Queue A item 10), and the mesh-sharded step's
``microbatch_arrays`` (item 14).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from .. import constants as C
from ..config import Config
from ..ops import peaks as peaks_ops
from .preprocess import Preprocessor

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
        """Validation batches ``({"image", "confmaps"}, n)`` on the device.
        The split is static, so it is gathered once and sliced per call."""
        if not hasattr(self, "_val_cache"):
            ids = torch.as_tensor(self.val_inds, device=self.data["box"].device)
            self._val_cache = {"image": self.data["box"][ids],
                               "confmaps": self.data["confmaps"][ids]}
        n = len(self.val_inds)
        for i in range(0, n, batch_size):
            stop = min(i + batch_size, n)
            yield ({k: v[i:stop].to(self.device) for k, v in self._val_cache.items()},
                   stop - i)

    def gather(self, ids) -> dict[str, torch.Tensor]:
        """``{"image", "confmaps"}`` of samples ``ids``, on the device."""
        ids = torch.as_tensor(np.asarray(ids), device=self.data["box"].device)
        return {"image": self.data["box"][ids].to(self.device),
                "confmaps": self.data["confmaps"][ids].to(self.device)}

    # -- train-step feeds ----------------------------------------------------
    def step_payload(self, idx: np.ndarray) -> tuple[dict, torch.Tensor]:
        """``(data, idx)`` for the train step: the whole device-resident
        dict and the global (accum, B) indices, gathered inside the step."""
        return self.data, torch.as_tensor(idx, device=self.device)


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
                  for k in ("box", "peaks", "peak_vals") if k in self.data}
        if "peaks" not in self.data:
            window["confmaps"] = self.data["confmaps"][flat].to(self.device)
        local = torch.arange(flat.numel(), dtype=torch.int32).reshape(idx.shape)
        return window, local.to(self.device)


def build_dataset(
    cfg: Config,
    arrays: dict[str, np.ndarray] | None = None,
    preprocessor: Preprocessor | None = None,
    *,
    device: torch.device | str,
) -> tuple[DeviceDataset, Preprocessor]:
    """Preprocess (``cfg.data_path``'s H5 file, or ``arrays``) and stage
    the samples on ``device``."""
    if cfg.model_type in (C.ALL_CAMS_DISENTANGLED_PER_WING_CNN,
                          C.ALL_CAMS_DISENTANGLED_PER_WING_VIT):
        raise NotImplementedError(
            f"model type {cfg.model_type!r}: the camera-matrix arrays (and "
            "estimate_cameras) of the disentangled models are ROADMAP Queue A "
            "item 10")
    pre = preprocessor or Preprocessor(cfg, arrays)
    pre.do_preprocess()
    data = {"box": pre.get_box(), "confmaps": pre.get_confmaps()}
    nbytes = sum(np.asarray(v).nbytes for v in data.values())
    use_host = cfg.host_resident_data or (
        nbytes > cfg.device_dataset_budget_mb * 2**20
    )
    cls = HostDataset if use_host else DeviceDataset
    return cls(cfg, data, device=device), pre
