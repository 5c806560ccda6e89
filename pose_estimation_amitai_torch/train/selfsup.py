"""Self-supervised inpainting pretraining, on the device (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/train/selfsup.py`` (reference:
pytorch/self supervision/train_self_supervision.py):

* per sample, one of the two wing-mask channels is selected, so the input
  is (H, W, 4) = 3 time channels + 1 wing mask (:43-44);
* holes: 3 square holes at random wing-mask pixels, sized
  ``sqrt(nnz(mask)) // 2``, and 5 holes of 16 px at random fly-body pixels
  (``create_holes``, :70-95);
* the same random affine warp on the holed input and the clean target
  (:46-63), the port's gather warp (``ops.affine.augment_pair``; JAX's
  default is its separable warp, the known deviation of ROADMAP A6(ii));
* objective: MSE of the reconstruction against the clean (warped) image in
  float32 (:132-224).

Hole centres are drawn without replacement by Gumbel-top-k over mask
logits (the twin of ``np.random.choice(replace=False)``), holes are
elementwise box masks, and every draw of a step comes from a
``torch.Generator`` seeded from ``SeedSequence((seed, step))``, as the
supervised train step's (train/loop.py ``step_generator``): the same state
and step draw the same; the draws themselves are not JAX's. Validation
draws from a generator derived from the config seed alone, so its holes
and warps are the same every epoch and on resume.

Downstream, the pretrained encoder re-heads a supervised model through the
trainer's ``pretrained_encoder_path`` (reference ``PretrainedLEAP``,
pytorch/NNs warehouse/NNs.py:38-62).
"""

from __future__ import annotations

import json
import os
import sys
from datetime import date
from time import time
from typing import Callable

import numpy as np
import torch
from torch.func import functional_call

from .. import viz
from ..config import Config
from ..models.cnn import BasicNet
from ..ops import affine
from . import checkpoint as ckpt
from .loop import (
    PlateauScheduler,
    TrainState,
    _init_params,
    adam_update,
    create_optimizer,
    step_generator,
)

NUM_WING_HOLES = 3  # train_self_supervision.py:81
NUM_BODY_HOLES = 5  # train_self_supervision.py:82
BODY_HOLE_SIZE = 16  # train_self_supervision.py:71
VAL_STEP = 0x7FFFFFFF  # the validation generator's "step": seed-only draws


def _sample_coords_topk(
    generator: torch.Generator, weights: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, k) row and column coordinates per sample, drawn without
    replacement among the pixels where the (B, H, W) ``weights`` are > 0:
    Gumbel-top-k over logits 0 there and -inf elsewhere. A sample with fewer
    than k such pixels takes them all, the rest from the -inf ones."""
    b, h, w = weights.shape
    logits = torch.where(weights.reshape(b, -1) > 0, 0.0, float("-inf"))
    u = torch.rand((b, h * w), generator=generator, device=weights.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    idx = torch.topk(logits + gumbel, k, dim=1).indices
    return idx // w, idx % w


def _box_hole_mask(h: int, w: int, cy: torch.Tensor, cx: torch.Tensor,
                   size) -> torch.Tensor:
    """(B, k, H, W) bool masks of size x size squares whose top-left corners
    are clipped at 0 (reference: ``max(0, x - hole // 2)``, :84-90).
    ``cy``, ``cx`` (B, k); ``size`` an int or (B,) tensor."""
    size = torch.as_tensor(size, device=cy.device)
    size = size.reshape(-1, 1) if size.dim() else size
    y0 = (cy - size // 2).clamp_min(0)[..., None, None]
    x0 = (cx - size // 2).clamp_min(0)[..., None, None]
    s = size[..., None, None] if size.dim() else size
    rows = torch.arange(h, device=cy.device)[:, None]
    cols = torch.arange(w, device=cy.device)[None, :]
    return (rows >= y0) & (rows < y0 + s) & (cols >= x0) & (cols < x0 + s)


def create_holes(generator: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """Punch wing and body holes into (B, H, W, 4) images, on their device.

    Channel layout [t0, t1, t2, wing_mask]. The wing hole size is
    ``sqrt(nnz(mask)) // 2`` per sample (the root taken in float32); body
    pixels are where the summed time channels exceed 0 (reference:
    train_self_supervision.py:70-95). Every channel of a hole pixel is
    zeroed."""
    b, h, w, _ = images.shape
    mask = images[..., -1]
    body = images[..., :3].sum(dim=-1) > 0
    wing_size = (torch.count_nonzero(mask > 0, dim=(1, 2)).float().sqrt()
                 .to(torch.int64)) // 2
    wy, wx = _sample_coords_topk(generator, mask, NUM_WING_HOLES)
    by, bx = _sample_coords_topk(generator, body.float(), NUM_BODY_HOLES)
    hole = (_box_hole_mask(h, w, wy, wx, wing_size).any(dim=1)
            | _box_hole_mask(h, w, by, bx, BODY_HOLE_SIZE).any(dim=1))
    return images * (~hole)[..., None]


def select_wing_channel(box: torch.Tensor, which: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 5) -> (B, H, W, 4): the time channels and, per sample, the
    second wing mask where ``which`` (B,) is true, else the first
    (reference: train_self_supervision.py:42-44)."""
    mask = torch.where(which[:, None, None], box[..., 4], box[..., 3])
    return torch.cat([box[..., :3], mask[..., None]], dim=-1)


def make_prepare(cfg: Config) -> Callable:
    """``prepare(generator, box) -> (holed, clean)``: box (B, H, W, 5) ->
    the selected-mask clean image and its holed copy, warped together."""
    order = min(int(cfg.interpolation_order), 3)

    def prepare(generator: torch.Generator, box: torch.Tensor):
        which = torch.rand(box.shape[0], generator=generator, device=box.device) < 0.5
        clean = select_wing_channel(box, which)
        holed = create_holes(generator, clean)
        if cfg.do_augmentations:
            holed, clean = affine.augment_pair(
                generator, holed, clean, rotation_range=cfg.rotation_range,
                xy_shifts=cfg.xy_shifts, zoom_range=cfg.zoom_range,
                do_horizontal_flip=cfg.horizontal_flip,
                do_vertical_flip=cfg.vertical_flip, order=order)
        return holed, clean

    return prepare


def make_loss_and_grads(model: torch.nn.Module) -> Callable:
    """``fn(params, holed, clean, generator) -> (loss, grads)``: the
    reconstruction MSE in float32 of the training forward (dropout from
    ``generator``) and its gradient for every parameter."""

    def fn(params: dict, holed: torch.Tensor, clean: torch.Tensor,
           generator: torch.Generator):
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        model.train()
        recon = functional_call(model, live, (holed,), {"generator": generator})
        loss = torch.square(recon.float() - clean).mean()
        grads = torch.autograd.grad(loss, list(live.values()))
        return loss.detach(), dict(zip(live, grads))

    return fn


def make_selfsup_step(model: torch.nn.Module, cfg: Config) -> Callable:
    """``step(state, holed, clean, generator, lr_scale=1.0) -> (state,
    loss)``: one Adam update of the inpainting model on a prepared batch."""
    loss_and_grads = make_loss_and_grads(model)

    def step(state: TrainState, holed, clean, generator, lr_scale: float = 1.0):
        loss, grads = loss_and_grads(state.params, holed, clean, generator)
        params, opt_state = adam_update(cfg, state, grads, lr_scale)
        return state.replace(step=state.step + 1, params=params,
                             opt_state=opt_state), loss

    return step


class SelfSupTrainer:
    """Inpainting pretrainer over per-frame crops, on ``device``.

    Data: (N, H, W, 5) float32 crops ([t0, t1, t2, mask_L, mask_R]) -- the
    supervised pipeline's box arrays or a crops directory of .npy files
    (the reference's layout, train_self_supervision.py:24-34), held on the
    device. The model is an inpainting ``BasicNet`` with 4 output channels,
    initialised as flax initialises it, trained with Adam under
    ``PlateauScheduler``; each epoch writes ``checkpoint.pt`` (and
    ``best_model.pt`` on a better validation loss) to the run directory and,
    where matplotlib is, a reconstruction PNG."""

    def __init__(self, cfg: Config, crops: np.ndarray, *, device: torch.device | str):
        self.cfg = cfg
        self.device = torch.device(device)
        self.rng = np.random.default_rng(cfg.seed)
        n = crops.shape[0]
        order = self.rng.permutation(n)
        n_val = max(1, round(n * min(cfg.val_fraction, 0.5)))
        self.val_inds = order[:n_val]
        self.train_inds = order[n_val:]
        self.data = torch.as_tensor(np.asarray(crops, np.float32), device=self.device)

        self.run_name = f"self_supervision_{date.today().strftime('%b %d')}"
        self.run_path = self._create_run_folders()

        with torch.device("meta"):  # the geometry; parameters live in the state
            self.model = BasicNet(
                4, out_channels=4, filters=cfg.num_base_filters,
                kernel_size=cfg.kernel_size, dilation=cfg.dilation_rate,
                dropout=cfg.dropout_ratio, num_blocks=cfg.num_blocks,
                flavor=cfg.arch_flavor,
                dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32)
        params = {k: v.to(self.device) for k, v in _init_params(self.model, cfg.seed).items()}
        self.state = TrainState(
            step=0, params=params,
            opt_state=create_optimizer(cfg, list(params.values())).state_dict(),
            seed=cfg.seed)
        self.scheduler = PlateauScheduler(cfg)
        self.best_loss = float("inf")
        self.prepare = make_prepare(cfg)
        self.step = make_selfsup_step(self.model, cfg)

    def train_step(self, ids: np.ndarray, lr_scale: float = 1.0) -> torch.Tensor:
        """One update on the crops ``ids``; returns the loss, on the device."""
        gen = step_generator(self.state.seed, self.state.step, 0, self.device)
        box = self.data[torch.as_tensor(ids, device=self.device).long()]
        holed, clean = self.prepare(gen, box)
        self.state, loss = self.step(self.state, holed, clean, gen, lr_scale)
        return loss

    def eval_step(self, ids: np.ndarray):
        """(loss, holed, clean, recon) of the eval forward on the crops
        ``ids``, with holes and warps drawn from the config seed alone."""
        gen = step_generator(int(self.cfg.seed), VAL_STEP, 0, self.device)
        box = self.data[torch.as_tensor(ids, device=self.device).long()]
        holed, clean = self.prepare(gen, box)
        self.model.eval()
        with torch.no_grad():
            recon = functional_call(self.model, self.state.params, (holed,)).float()
            loss = torch.square(recon - clean).mean()
        return loss, holed, clean, recon

    def _create_run_folders(self) -> str:
        run_path = os.path.join(self.cfg.base_output_path, self.run_name)
        initial, i = run_path, 1
        while os.path.exists(run_path):
            run_path = "%s_%02d" % (initial, i)
            i += 1
        os.makedirs(os.path.join(run_path, "reconstructions"))
        with open(os.path.join(run_path, "configuration.json"), "w") as f:
            json.dump(self.cfg.raw or self.cfg.to_dict(), f, indent=4)
        return run_path

    def train(self) -> dict[str, list[float]]:
        """Run ``cfg.epochs`` epochs; returns the per-epoch ``train_loss``
        and ``val_loss``."""
        cfg = self.cfg
        t0 = time()
        bs = cfg.batch_size
        history: dict[str, list[float]] = {"train_loss": [], "val_loss": []}
        steps = max(1, 1 if cfg.debug_mode else cfg.batches_per_epoch)
        for epoch in range(cfg.epochs):
            self.rng.shuffle(self.train_inds)
            losses = []
            for s in range(steps):
                # wrap-around index ring (simple_data_generator.py:31-70): an
                # out-of-range slice cycles the shuffled train set
                ids = self.train_inds[(s * bs + np.arange(bs)) % len(self.train_inds)]
                losses.append(self.train_step(ids, self.scheduler.lr_scale))
            train_loss = float(torch.stack(losses).mean())  # one fetch an epoch
            val_ids = np.resize(self.val_inds, bs)
            val_loss, holed, clean, recon = self.eval_step(val_ids)
            val_loss = float(val_loss)
            self.scheduler.step(val_loss)
            history["train_loss"].append(train_loss)
            history["val_loss"].append(val_loss)
            print(f"Epoch {epoch + 1}/{cfg.epochs} train {train_loss:.6f} "
                  f"val {val_loss:.6f}", flush=True)
            if val_loss < self.best_loss:
                self.best_loss = val_loss
                ckpt.save_checkpoint(self.run_path, self.state, epoch, val_loss, best=True)
            ckpt.save_checkpoint(self.run_path, self.state, epoch, val_loss,
                                 scheduler_state=self.scheduler.state_dict(),
                                 best_loss=self.best_loss)
            if viz.available():
                viz.show_reconstruction(
                    holed[0].float().cpu().numpy(), recon[0].cpu().numpy(),
                    clean[0].float().cpu().numpy(),
                    os.path.join(self.run_path, "reconstructions", f"epoch_{epoch + 1}.png"))
        print("Pretraining runtime: %.1f mins" % ((time() - t0) / 60), flush=True)
        return history


def main(argv: list[str] | None = None, *, device: torch.device | str = "cuda") -> None:
    """CLI: pretrain from a directory of .npy crops or an H5 dataset's box
    array (``argv``: config path, then the source; default the config's
    data path). H5 boxes of 5 dimensions (frames, cameras, H, W, C) are
    flattened over cameras and normalised as the supervised Preprocessor
    normalises (uint8 / 255), so the encoder sees the input scale
    fine-tuning will feed it."""
    argv = argv if argv is not None else sys.argv[1:]
    cfg = Config.from_json(argv[0])
    src = argv[1] if len(argv) > 1 else cfg.data_path
    if os.path.isdir(src):
        files = sorted(os.listdir(src))
        crops = np.stack([np.load(os.path.join(src, f)) for f in files])
    else:
        import h5py

        from ..data.preprocess import normalize

        with h5py.File(src, "r") as f:
            box = f["box"][:]
        if box.ndim == 5:  # (F, cams, H, W, C) -> flatten cameras
            box = box.reshape(-1, *box.shape[2:])
        crops = normalize(box)
    SelfSupTrainer(cfg, crops, device=device).train()


if __name__ == "__main__":
    main()
