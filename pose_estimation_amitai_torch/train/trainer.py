"""The Trainer: run folders, epoch loop, metrics artifacts, checkpoints,
resume (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/train/trainer.py``'s
single-device path (reference: pytorch/train_pytorch.py:37-397,
tensorflow/train.py:34-153), with the same run-directory contract and the
port's ``.pt`` files in place of ``.msgpack``:

* auto-suffixed run folder ``<model_type>_<Mon DD>[_NN]`` with weights/,
  viz_pred/, viz_confmaps/, histograms/, l2_histograms/,
  l2_histograms_per_point/ and a ``training code/`` snapshot of the port's
  package (train.py:122-147);
* ``configuration.json`` (train.py:108-110);
* ``losses.csv`` per epoch (train_pytorch.py:262-283), ``history.csv``
  (CallBacks.py:17-33) and ``history.mat``;
* L2 histograms, per-point histograms, prediction overlays and loss curves
  every ``viz_every`` epochs, where matplotlib is installed (without it one
  line says they are skipped and everything else is written);
* ``initial_model.pt``, ``checkpoint.pt`` every ``checkpoint_every``
  epochs, ``best_model.pt`` on a better validation loss,
  ``weights/weights.{epoch:03d}-{val_loss:.9f}.pt`` with
  ``save_every_epoch``, ``final_confmaps_model.pt``; true resume from
  ``resume_from``.

One epoch is ``batches_per_epoch // accumulation_steps`` optimiser updates
of the train step (train/loop.py); the losses are fetched from the device
once an epoch. ``coarse_model_path`` (C2F's frozen coarse stage) and
``pretrained_encoder_path`` (an encoder from self-supervised pretraining,
train/selfsup.py, or an imported one) read the port's run directories and
``.pt`` files, the JAX package's msgpack checkpoints, reference checkpoints
(keras ``.h5``, torch ``.pth``, through importers.py) and ``cli import``
snapshots with their BatchNorm statistics. The JAX trainer's mesh and
pipeline branches (ROADMAP Queue A item 14) raise: one H100 has nothing to
shard over, and no single-device stand-in is taken silently.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import shutil
from datetime import date
from time import time

import numpy as np
import torch

from .. import viz, weights
from ..config import Config
from ..data.pipeline import build_dataset
from ..importers import (
    adapt_stem_in_channels,
    import_reference_checkpoint,
    is_reference_checkpoint,
)
from ..models import build_model
from ..ops import peaks as peaks_ops
from . import checkpoint as ckpt
from .loop import (
    PlateauScheduler,
    create_train_state,
    make_eval_step,
    make_predict_fn,
    make_train_step,
    model_args,
)

LOSSES_HEADER = ["Epoch", "Train Loss", "Val Loss", "L2 Loss", "L2 Std",
                 "L2 Max Outlier", "Epoch Seconds"]
RUN_SUBFOLDERS = ("weights", "viz_pred", "viz_confmaps", "histograms",
                  "l2_histograms", "l2_histograms_per_point")


def _graft_tree(
    tgt: dict[str, torch.Tensor], src: dict[str, torch.Tensor], what: str
) -> dict[str, torch.Tensor]:
    """``src`` cast into the template ``tgt`` (name -> tensor): the key sets
    must be equal (the missing and unexpected names are listed) and every
    shape must match (each mismatch named) before anything is cast to the
    template's dtype and device."""
    missing = sorted(set(tgt) - set(src))
    extra = sorted(set(src) - set(tgt))
    if missing or extra:
        parts = []
        if missing:
            parts.append("missing " + ", ".join(missing[:5]))
        if extra:
            parts.append("unexpected " + ", ".join(extra[:5]))
        raise ValueError(
            f"{what} tree does not match the model's ({len(src)} loaded leaves "
            f"vs {len(tgt)} expected; " + "; ".join(parts)
            + " — is arch/num_blocks set right?)")
    mismatches = [f"{k}: {tuple(tgt[k].shape)} vs {tuple(src[k].shape)}"
                  for k in tgt if tuple(tgt[k].shape) != tuple(src[k].shape)]
    if mismatches:
        raise ValueError(f"{what} shapes do not match the model's "
                         "(is arch set right?): " + "; ".join(mismatches[:5]))
    return {k: torch.as_tensor(src[k]).to(dtype=t.dtype, device=t.device)
            for k, t in tgt.items()}


class _CkptSync:
    """Synchronous stand-in for AsyncCheckpointer (``async_checkpoint=0``);
    resolves ``ckpt.save_*`` at call time, so patched writers take effect."""

    def save_checkpoint(self, *args, **kwargs) -> None:
        ckpt.save_checkpoint(*args, **kwargs)

    def save_params(self, *args, **kwargs) -> None:
        ckpt.save_params(*args, **kwargs)

    def wait(self) -> None:
        pass


class Trainer:
    """One training run of ``cfg`` on ``device``: ``Trainer(cfg,
    arrays=None, *, device).train()``. ``cfg`` may be a JSON path;
    ``arrays`` replaces the H5 file at ``cfg.data_path``
    (data/synthetic.py)."""

    def __init__(
        self, cfg: Config | str, arrays: dict[str, np.ndarray] | None = None,
        *, device: torch.device | str,
    ):
        if isinstance(cfg, str):
            cfg = Config.from_json(cfg)
        if cfg.mesh_shape or cfg.pipeline_stages > 1:
            raise NotImplementedError(
                "mesh_shape / pipeline_stages: the parallel strategies are "
                "ROADMAP Queue A item 14")
        self.cfg = cfg
        self.device = torch.device(device)
        self.batches_per_epoch = 1 if cfg.debug_mode else cfg.batches_per_epoch
        if cfg.nan_debug:
            # pytorch/train_pytorch.py:117
            torch.autograd.set_detect_anomaly(True)

        self.dataset, self.preprocessor = build_dataset(cfg, arrays, device=self.device)
        self.run_name = f"{cfg.model_type}_{date.today().strftime('%b %d')}"
        self.run_path = self._create_run_folders()
        self._save_configuration()

        sample_ids = self.dataset.train_inds[: max(1, min(2, len(self.dataset.train_inds)))]
        sample = self.dataset.gather(np.asarray(sample_ids, np.int32))
        img_shape = tuple(sample["image"].shape[1:])
        num_out = sample["confmaps"].shape[-1]
        with torch.device("meta"):  # the geometry; parameters live in the state
            self.model = build_model(cfg, img_shape, num_out)
        self.state = create_train_state(self.model, cfg, cfg.seed, device=self.device)
        self._maybe_load_pretrained()
        self.train_step = make_train_step(self.model, cfg)
        self.eval_step = make_eval_step(self.model, cfg)
        self._predict = make_predict_fn(self.model)

        self.scheduler = PlateauScheduler(cfg)
        # 'epochs pointwise loss' (tensorflow/train_config.json:11): heatmap
        # MSE first, the decoded-coordinate pointwise loss from this epoch on
        self._pointwise_switch_epoch = (
            cfg.epochs_pointwise_loss
            if cfg.epochs_pointwise_loss > 0
            and cfg.loss_function not in ("pointwise", "point_wise_loss")
            else None)
        self._ckpt_writer = ckpt.AsyncCheckpointer() if cfg.async_checkpoint else _CkptSync()
        self.pngs_skipped = False

        self.start_epoch = 0
        self.best_loss = float("inf")
        self._best_written = float("inf")
        if cfg.resume_from:
            self.state, meta = ckpt.restore_checkpoint(cfg.resume_from, self.state)
            self.start_epoch = int(meta.get("epoch", -1)) + 1
            self.best_loss = float(meta.get("best_loss", meta.get("val_loss", float("inf"))))
            self._best_written = self.best_loss  # a best_model at best_loss is on disk
            if meta.get("scheduler"):
                self.scheduler.load_state_dict(meta["scheduler"])
            # the epochs run before each shuffled the train order: replay
            # them, so the resumed epochs draw the batches an unbroken run
            # draws (with the step-seeded draws, resume is then exact)
            for _ in range(self.start_epoch):
                self.dataset.shuffle_train_indices()
            print(f"Resumed from {cfg.resume_from} at epoch {self.start_epoch}", flush=True)

    # ------------------------------------------------------------------
    @staticmethod
    def _load_source(path: str) -> tuple[dict, dict]:
        """(params, batch_stats) as flax-layout trees from any weights
        source, told apart by content: a reference checkpoint through
        importers.py, otherwise ``weights.load_checkpoint`` (``cli import``
        snapshots, the port's run directories and ``.pt`` files, the JAX
        package's msgpack checkpoints)."""
        if is_reference_checkpoint(path):
            imported = import_reference_checkpoint(path)
            return imported.params, imported.batch_stats or {}
        return weights.load_checkpoint(path)

    def _maybe_load_pretrained(self) -> None:
        """C2F's frozen coarse stage from ``coarse_model_path`` (a trained
        keras coarse save as the reference loads it, tensorflow/
        Network.py:172-176, or any source :meth:`_load_source` reads), and
        the encoder of ``pretrained_encoder_path`` (the PretrainedLEAP
        re-heading, pytorch/NNs warehouse/NNs.py:38-62): its ``encoder``
        subtree grafted over the model's, a 3-channel ImageNet stem inflated
        to the frames' channels (``importers.adapt_stem_in_channels``), and
        the encoder's BatchNorm statistics grafted into
        ``TrainState.batch_stats`` where the source has them."""
        cfg = self.cfg
        params = dict(self.state.params)
        coarse = {k: v for k, v in params.items() if k.startswith("coarse.")}
        if cfg.coarse_model_path and coarse:
            tree, _ = self._load_source(cfg.coarse_model_path)
            loaded = {f"coarse.{k}": v for k, v in weights.flax_to_state_dict(tree).items()}
            params.update(_graft_tree(coarse, loaded, "coarse model"))
            self.state = self.state.replace(params=params)
        enc = {k: v for k, v in params.items() if k.startswith("encoder.")}
        if not (cfg.pretrained_encoder_path and enc):
            return
        tree, stats = self._load_source(cfg.pretrained_encoder_path)
        src = tree.get("encoder", tree)
        stem = src.get("stem")
        tgt_stem = enc.get("encoder.stem.weight")  # (O, I, kh, kw)
        if (stem is not None and tgt_stem is not None
                and stem["kernel"].shape[2] != tgt_stem.shape[1]):
            src = {**src, "stem": {**stem, "kernel": adapt_stem_in_channels(
                np.asarray(stem["kernel"]), int(tgt_stem.shape[1]))}}
        loaded = {f"encoder.{k}": v for k, v in weights.flax_to_state_dict(src).items()}
        params.update(_graft_tree(enc, loaded, "pretrained encoder"))
        self.state = self.state.replace(params=params)
        src_stats = (stats or {}).get("encoder")
        enc_stats = {k: v for k, v in self.state.batch_stats.items()
                     if k.startswith("encoder.")}
        if src_stats and enc_stats:
            loaded = {f"encoder.{k}": v for k, v in
                      weights.flax_to_state_dict({}, None, src_stats).items()}
            self.state = self.state.replace(batch_stats={
                **self.state.batch_stats,
                **_graft_tree(enc_stats, loaded, "pretrained encoder BN stats")})

    def _create_run_folders(self) -> str:
        """Auto-suffixed run dir + code snapshot (tensorflow/train.py:122-147)."""
        run_path = os.path.join(self.cfg.base_output_path, self.run_name)
        if not self.cfg.clean:
            initial, i = run_path, 1
            while os.path.exists(run_path):
                run_path = "%s_%02d" % (initial, i)
                i += 1
        if os.path.exists(run_path):
            shutil.rmtree(run_path)
        os.makedirs(run_path)
        for sub in RUN_SUBFOLDERS:
            os.makedirs(os.path.join(run_path, sub))
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        shutil.copytree(
            pkg_root, os.path.join(run_path, "training code", os.path.basename(pkg_root)),
            ignore=shutil.ignore_patterns("__pycache__"))
        print("Created folder:", run_path, flush=True)
        return run_path

    def _save_configuration(self) -> None:
        with open(os.path.join(self.run_path, "configuration.json"), "w") as f:
            json.dump(self.cfg.raw or self.cfg.to_dict(), f, indent=4)

    # ------------------------------------------------------------------
    def train(self) -> dict[str, list[float]]:
        """Run the epochs from ``start_epoch`` to ``cfg.epochs``; returns
        the per-epoch ``train_loss``, ``val_loss``, ``l2`` (mean pixel L2)
        and ``epoch_seconds``."""
        cfg = self.cfg
        t0 = time()
        train_losses: list[float] = []
        val_losses: list[float] = []
        l2_means: list[float] = []
        l2_stds: list[float] = []
        l2_max: list[float] = []
        epoch_secs: list[float] = []
        accum = max(1, cfg.accumulation_steps)
        updates_per_epoch = max(1, self.batches_per_epoch // accum)
        if self.start_epoch == 0:
            # tensorflow/train.py:88 ``initial_model.h5``
            ckpt.save_params(os.path.join(self.run_path, "initial_model.pt"),
                             self.state.params, self.state.batch_stats)
        profiler = contextlib.nullcontext()
        if cfg.profile:
            profiler = torch.profiler.profile(
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    os.path.join(self.run_path, "profile")))
        with profiler:
            for epoch in range(self.start_epoch, cfg.epochs):
                print(f"Epoch {epoch + 1}/{cfg.epochs}", flush=True)
                if (self._pointwise_switch_epoch is not None
                        and epoch >= self._pointwise_switch_epoch):
                    self._switch_to_pointwise_loss()
                t_epoch = time()
                self.dataset.shuffle_train_indices()
                step_losses = []
                for _ in range(updates_per_epoch):
                    idx = self.dataset.step_indices(cfg.batch_size, accum)
                    data, step_idx = self.dataset.step_payload(idx)
                    self.state, loss = self.train_step(
                        self.state, data, step_idx, self.scheduler.lr_scale)
                    step_losses.append(loss)
                # one fetch an epoch: a float() a step would wait for each
                train_loss = float(torch.stack(step_losses).mean())
                train_losses.append(train_loss)
                print(f"Train Loss: {train_loss:.7f}", flush=True)

                # -- validation (pytorch/train_pytorch.py:150-194) ---------
                val_loss, l2_all, l2_per_point = self.evaluate()
                val_losses.append(val_loss)
                print(f"Val Loss: {val_loss:.7f}", flush=True)
                self.scheduler.step(val_loss)
                l2_means.append(float(np.mean(l2_all)))
                l2_stds.append(float(np.std(l2_all)))
                l2_max.append(float(np.max(l2_all)))
                epoch_secs.append(time() - t_epoch)

                if val_loss < self.best_loss:
                    # best-model writes gated on a least relative improvement
                    # (best_min_rel_delta; 0 = every improvement); the marker
                    # tracks every one
                    write_best = val_loss < self._best_written * (1.0 - cfg.best_min_rel_delta)
                    self.best_loss = val_loss
                    if write_best:
                        self._best_written = val_loss
                        self._ckpt_writer.save_checkpoint(
                            self.run_path, self.state, epoch, val_loss, best=True)
                if cfg.save_every_epoch:
                    self._ckpt_writer.save_params(
                        os.path.join(self.run_path, "weights",
                                     f"weights.{epoch + 1:03d}-{val_loss:.9f}.pt"),
                        self.state.params, self.state.batch_stats)
                if (epoch + 1) % max(1, cfg.checkpoint_every) == 0:
                    self._ckpt_writer.save_checkpoint(
                        self.run_path, self.state, epoch, val_loss,
                        scheduler_state=self.scheduler.state_dict(),
                        best_loss=self.best_loss)
                self._save_epoch_artifacts(
                    epoch, train_losses, val_losses, l2_means, l2_stds, l2_max,
                    l2_all, l2_per_point, epoch_secs)
        self._ckpt_writer.wait()  # land the write in flight, raise its error
        # tensorflow/train.py:102-104 ``final_confmaps_model.h5``
        ckpt.save_params(os.path.join(self.run_path, "final_confmaps_model.pt"),
                         self.state.params, self.state.batch_stats)
        print("Total runtime first loss: %.1f mins" % ((time() - t0) / 60), flush=True)
        return {"train_loss": train_losses, "val_loss": val_losses, "l2": l2_means,
                "epoch_seconds": epoch_secs}

    def _switch_to_pointwise_loss(self) -> None:
        self.train_step = make_train_step(
            self.model, self.cfg.replace(loss_function="pointwise"))
        self._pointwise_switch_epoch = None
        print("Switched training loss to pointwise (decoded coordinates)", flush=True)

    # ------------------------------------------------------------------
    def evaluate(self) -> tuple[float, np.ndarray, np.ndarray]:
        """Validation MSE (each batch weighted by its valid rows) and the
        decoded-peak pixel L2, flat and (K, N) per point; fetched once."""
        counts, mses, l2s = [], [], []
        for batch, n_valid in self.dataset.val_payloads(self.cfg.batch_size):
            mse, l2 = self.eval_step(self.state, batch)
            counts.append(n_valid)
            mses.append(mse)
            l2s.append(l2)
        mses = torch.stack(mses).cpu().numpy()
        l2_per_sample = torch.cat(l2s).cpu().numpy()  # (N, K)
        count = sum(counts)
        total = sum(float(m) * n for m, n in zip(mses, counts))
        return total / max(count, 1), l2_per_sample.flatten(), l2_per_sample.T

    def _save_epoch_artifacts(
        self, epoch, train_losses, val_losses, l2_means, l2_stds, l2_max,
        l2_all, l2_per_point, epoch_secs,
    ) -> None:
        rp = self.run_path
        with open(os.path.join(rp, "losses.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(LOSSES_HEADER)
            for i in range(len(train_losses)):
                w.writerow([self.start_epoch + i + 1, f"{train_losses[i]:.4g}",
                            f"{val_losses[i]:.4g}", f"{l2_means[i]:.4g}",
                            f"{l2_stds[i]:.4g}", f"{l2_max[i]:.4g}",
                            f"{epoch_secs[i]:.2f}"])
        with open(os.path.join(rp, "history.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["epoch", "loss", "val_loss"])
            for i in range(len(train_losses)):
                w.writerow([self.start_epoch + i, train_losses[i], val_losses[i]])
        from scipy.io import savemat

        savemat(os.path.join(rp, "history.mat"),
                {"loss": train_losses, "val_loss": val_losses, "val_l2_loss": l2_means})
        # the PNGs every viz_every epochs and on the final one (<= 0: the
        # final one only); the CSV/MAT metrics above every epoch
        every = int(self.cfg.viz_every)
        is_final = (epoch + 1) == self.cfg.epochs
        if not is_final and (every <= 0 or (epoch + 1) % every):
            return
        if not viz.available():
            if not self.pngs_skipped:
                print("matplotlib is not installed: the PNG artifacts are skipped",
                      flush=True)
            self.pngs_skipped = True
            return
        viz.plot_history(train_losses, val_losses, os.path.join(rp, "loss_graph.png"),
                         start_epoch=min(4, max(len(train_losses) - 1, 0)))
        viz.plot_history(train_losses, val_losses, os.path.join(rp, "history.png"))
        viz.l2_histogram(l2_all, epoch, os.path.join(
            rp, "l2_histograms", f"validation_epoch_{epoch + 1}.png"))
        viz.l2_histogram_per_point(l2_per_point, epoch, os.path.join(
            rp, "l2_histograms_per_point", f"validation_epoch_{epoch + 1}.png"))
        self._save_validation_image(epoch)

    def _save_validation_image(self, epoch: int) -> None:
        """Prediction overlay and map grid of the first validation sample
        (pytorch/train_pytorch.py:222-251)."""
        if len(self.dataset.val_inds) == 0:
            return
        batch = self.dataset.gather(np.asarray(self.dataset.val_inds[:1], np.int32))
        pred = self._predict(self.state.params, *model_args(batch),
                             batch_stats=self.state.batch_stats)
        pts = peaks_ops.find_peaks(pred).cpu().numpy()[0]
        gt = peaks_ops.find_peaks(batch["confmaps"].float()).cpu().numpy()[0]
        viz.show_pred(batch["image"][0].float().cpu().numpy(), pts, gt, save_path=os.path.join(
            self.run_path, "viz_pred", f"validation_epoch_{epoch + 1}.png"))
        viz.show_confmap_grid(pred[0].cpu().numpy(), save_path=os.path.join(
            self.run_path, "viz_confmaps", f"confmaps_{epoch + 1:03d}.png"))
