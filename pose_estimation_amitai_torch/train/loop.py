"""Train and eval steps of the port: gather, on-device augmentation and
target rendering, dropout, backward, gradient accumulation, Adam.

Counterpart of ``pose_estimation_amitai_tpu/train/loop.py`` (reference:
pytorch/train_pytorch.py:98-197, its epoch loop with CUDA AMP and
``accumulation_steps``; tensorflow/train.py:87-106). One call of the train
step gathers each microbatch from the device-resident dataset, augments it
(or re-renders its targets from the stored peaks), runs the training forward
(bf16 compute over float32 parameters, each weight cast where its conv
applies it; no autocast, no loss scaling), takes float32 gradients, averages
them over ``accumulation_steps`` microbatches and applies one Adam update
scaled by ``lr_scale``.

The steps are functions of a :class:`TrainState` and return a new one; the
old state is left as it was. That holds for the BatchNorm families' running
averages too: each microbatch's training forward gives new ones (flax's
``mutable=["batch_stats"]``), threaded through the microbatches in order as
JAX's ``scan`` carries them. Camera-matrix batches (``P``, ``P_inv``) feed
the disentangled model, each view's augmentation warp folded into its
camera.

Every random draw (augmentation, mask re-dilation, dropout) comes from a
``torch.Generator`` seeded from (seed, step, microbatch), as JAX folds the
step into its key: the same state and step draw the same, a later step
draws anew, and resuming needs no generator state beyond the seed and the
step. The draws themselves are not JAX's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .. import constants as C
from ..config import Config
from ..models import augmentation_views, layout_masks_per_view, layout_views
from ..models.layers import StackedLayers, at_least_f32
from ..models.multicam import DenseGeneral
from ..models.norm import BatchNorm, collect_batch_stats
from ..models.vit import PatchEmbed
from ..ops import affine, geometry, peaks
from ..ops.gaussian import confmaps_from_peaks
from ..ops.morphology import random_mask_redilation

# std of a unit normal truncated to [-2, 2]: flax's lecun_normal divides by it
_TRUNCATED_STD = 0.87962566103423978
_HEAD_LAYER_NAMES = ("deconv4", "head_deconv")


@dataclass(frozen=True)
class TrainState:
    """Step counter, float32 module parameters (by ``state_dict`` name),
    the Adam state (``torch.optim.Adam.state_dict()``), the seed the
    step's random draws derive from, and the float32 BatchNorm running
    averages by ``state_dict`` buffer name ({} for models without)."""

    step: int
    params: dict[str, torch.Tensor]
    opt_state: dict
    seed: int
    batch_stats: dict[str, torch.Tensor] = field(default_factory=dict)

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def create_optimizer(cfg: Config, params) -> torch.optim.Adam:
    """Adam at ``cfg.learning_rate`` with betas (0.9, 0.999) and eps 1e-8,
    ``optax.adam``'s defaults (pytorch/train_pytorch.py:111)."""
    return torch.optim.Adam(params, lr=cfg.learning_rate)


def _lecun_normal(rng: np.random.Generator, shape: tuple, fan_in: int) -> np.ndarray:
    """flax's default kernel init: a normal truncated to +-2 std, scaled to
    variance 1 / fan_in."""
    z = rng.standard_normal(shape)
    while (bad := np.abs(z) > 2.0).any():
        z[bad] = rng.standard_normal(int(bad.sum()))
    return (z * (np.sqrt(1.0 / fan_in) / _TRUNCATED_STD)).astype(np.float32)


def _init_params(
    model: nn.Module, seed: int | np.random.Generator
) -> dict[str, torch.Tensor]:
    """Seeded float32 parameters, on the CPU, in ``named_parameters`` order,
    as flax initialises them: kernels lecun-normal over the fan-in (input
    channels x kernel taps, for a transposed conv and the ViT's stride-p
    patch conv too; the contracting dims of an attention projection; the
    input features of a ``Linear``, drawn in flax's (in, out) layout and
    laid out (out, in)), biases zero, BatchNorm and LayerNorm scales one,
    the ViT's positional embedding a unit normal (flax's ``normal(1.0)``);
    a :class:`StackedLayers` stack, each of its layers drawn in turn."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    params: dict[str, torch.Tensor] = {}
    stacks = [name for name, m in model.named_modules() if isinstance(m, StackedLayers)]
    for name, m in model.named_modules():
        if any(name.startswith(f"{s}.") for s in stacks):
            continue  # drawn with its stack
        if isinstance(m, StackedLayers):
            layers = [_init_params(m.layer, rng) for _ in range(m.depth)]
            for k in layers[0]:
                params[f"{name}.{k}"] = torch.stack([layer[k] for layer in layers])
            continue
        if isinstance(m, (BatchNorm, nn.LayerNorm)):
            params[f"{name}.weight"] = torch.ones(m.weight.shape)
            params[f"{name}.bias"] = torch.zeros(m.bias.shape)
            continue
        if isinstance(m, PatchEmbed):
            params[f"{name}.pos_embedding"] = torch.from_numpy(
                rng.standard_normal(tuple(m.pos_embedding.shape)).astype(np.float32))
            continue
        if isinstance(m, nn.Linear):
            w = _lecun_normal(rng, (m.in_features, m.out_features), m.in_features).T
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.in_channels * int(np.prod(m.kernel_size))
            w = _lecun_normal(rng, tuple(m.weight.shape), fan_in)
        elif isinstance(m, DenseGeneral):
            w = _lecun_normal(rng, tuple(m.weight.shape), m.fan_in)
        else:
            continue
        params[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        if m.bias is not None:
            params[f"{name}.bias"] = torch.zeros(m.bias.shape)
    names = [n for n, _ in model.named_parameters()]
    if set(params) != set(names):
        raise ValueError(
            f"{type(model).__name__}: no flax initialiser for "
            f"{sorted(set(names) - set(params))}")
    return {n: params[n] for n in names}


def init_batch_stats(
    model: nn.Module, device: torch.device | str
) -> dict[str, torch.Tensor]:
    """flax's initial running averages of every BatchNorm of ``model``:
    means 0, variances 1, float32 on ``device``."""
    stats: dict[str, torch.Tensor] = {}
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            n = m.weight.shape[0]
            stats[f"{name}.running_mean"] = torch.zeros(n, device=device)
            stats[f"{name}.running_var"] = torch.ones(n, device=device)
    return stats


def frozen_names(model: nn.Module, params) -> set[str]:
    """Parameters the train step leaves as they are: those under the
    model's ``frozen_prefixes`` (C2F's coarse stage, JAX's
    ``stop_gradient``)."""
    prefixes = getattr(model, "frozen_prefixes", ())
    return {k for k in params if k.startswith(prefixes)} if prefixes else set()


def create_train_state(
    model: nn.Module, cfg: Config, seed: int = 0, *, device: torch.device | str
) -> TrainState:
    """Seeded float32 parameters on ``device`` (the output head zeroed if
    ``cfg.head_zero_init``), a fresh Adam state over the parameters that
    train (not :func:`frozen_names`) and the initial running averages.
    ``model`` gives the geometry only; it may live on the meta device."""
    params = {k: v.to(device) for k, v in _init_params(model, seed).items()}
    if cfg.head_zero_init:
        params = zero_output_head(params)
    frozen = frozen_names(model, params)
    opt_state = create_optimizer(
        cfg, [v for k, v in params.items() if k not in frozen]).state_dict()
    return TrainState(step=0, params=params, opt_state=opt_state, seed=seed,
                      batch_stats=init_batch_stats(model, device))


def zero_output_head(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Zero the final heatmap layer's weight and bias ('deconv4' in the torch
    flavour, 'head_deconv' in the tf one), so training starts from the
    all-zeros prediction."""
    return {k: torch.zeros_like(v) if k.split(".")[-2] in _HEAD_LAYER_NAMES else v
            for k, v in params.items()}


def make_loss_fn(cfg: Config) -> Callable:
    """MSE of the maps in float32 at least (pytorch/train_pytorch.py:110), or
    the decoded-coordinate pointwise loss (tensorflow/Network.py:536-547) for
    ``loss_function`` "pointwise" and the ``*_TO_POINTS`` /
    ``*_POINTS_LOSS`` model types."""
    use_pointwise = cfg.loss_function in (
        "pointwise", "point_wise_loss"
    ) or cfg.model_type in (
        C.MODEL_18_POINTS_PER_WING_VIT_TO_POINTS,
        C.HEAD_TAIL_PER_CAM_POINTS_LOSS,
    )

    def loss_fn(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        pred, target = at_least_f32(pred), at_least_f32(target)
        if use_pointwise:
            return peaks.pointwise_loss(target, pred)
        return torch.square(pred - target).mean()

    return loss_fn


def step_generator(
    seed: int, step: int, microbatch: int, device: torch.device | str
) -> torch.Generator:
    """The generator of one microbatch's draws: a function of (seed, step,
    microbatch) only."""
    s = np.random.SeedSequence([seed, step, microbatch]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def model_args(batch: dict) -> tuple:
    """A batch's positional model inputs: the frames, and the cameras of
    the camera-matrix models (``P``, ``P_inv``)."""
    if "P" in batch:
        return (batch["image"], batch["P"], batch["P_inv"])
    return (batch["image"],)


def _microbatch_fn(
    model: nn.Module, cfg: Config, *, stored_targets: bool = False,
    expand: Callable | None = None,
) -> Callable:
    """``micro(params, batch_stats, data, ids, generator) -> (loss, grads,
    batch_stats)``: one microbatch's training forward and backward; the
    running averages it returns are new tensors (those it was given stay as
    they were). ``stored_targets``: without augmentation the stored maps are
    the targets (JAX's sharded step), not maps rendered at the stored peaks.
    ``expand``: a differentiable map from the parameters held to those the
    forward takes (tensor parallelism gathers its column shards); the
    gradients are the held parameters'."""
    loss_fn = make_loss_fn(cfg)
    order = min(int(cfg.interpolation_order), 3)
    warp_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    views = augmentation_views(cfg.model_type)
    aug = dict(rotation_range=cfg.rotation_range, xy_shifts=cfg.xy_shifts,
               zoom_range=cfg.zoom_range, do_horizontal_flip=cfg.horizontal_flip,
               do_vertical_flip=cfg.vertical_flip, shear_range=cfg.shear_range,
               order=order)
    bn_names = {m: name for name, m in model.named_modules() if isinstance(m, BatchNorm)}

    def batch(data: dict, ids: torch.Tensor, gen: torch.Generator):
        box = data["box"][ids]
        view_mats = None
        if cfg.do_augmentations and "peaks" in data:
            box, confmaps, view_mats = affine.augment_views_and_peaks(
                gen, box.to(warp_dtype), data["peaks"][ids], data["peak_vals"][ids],
                num_views=views, sigma=cfg.sigma, **aug)
        elif "peaks" in data and not stored_targets:
            confmaps = confmaps_from_peaks(
                data["peaks"][ids], tuple(box.shape[1:3]), cfg.sigma
            ) * data["peak_vals"][ids][:, None, None, :]
        else:
            confmaps = data["confmaps"][ids]
            # a camera model is never warped here: with no per-view matrix
            # to fold into P, its FTL would no longer match the pixels
            if cfg.do_augmentations and "P" not in data:
                box, confmaps = affine.augment_pair(gen, box, confmaps,
                                                    num_views=views, **aug)
        if cfg.do_augmentations and cfg.wings_masks_dilation > 0:
            box = random_mask_redilation(
                gen, box, cfg.wings_masks_dilation,
                num_views=layout_views(cfg.model_type),
                num_time_channels=1 if cfg.single_time_channel else 3,
                masks_per_view=layout_masks_per_view(cfg.model_type))
        if "P" not in data:
            return (box,), confmaps
        P, P_inv = data["P"][ids], data["P_inv"][ids]
        if view_mats is not None:
            # each view's warp folded into its camera: the FTL geometry
            # stays that of the warped pixels
            P, P_inv = geometry.compose_affine_into_cameras(
                view_mats, P, P_inv, crop_size=box.shape[-3])
        return (box, P, P_inv), confmaps

    def micro(params: dict, batch_stats: dict, data: dict, ids, gen: torch.Generator):
        ids = torch.as_tensor(ids, device=data["box"].device).long()
        args, confmaps = batch(data, ids, gen)
        frozen = frozen_names(model, params)
        live = {k: v.detach().requires_grad_(k not in frozen) for k, v in params.items()}
        model.train()
        with collect_batch_stats() as updates:
            full = live if expand is None else expand(live)
            pred = functional_call(model, {**full, **batch_stats}, args, {"generator": gen})
        loss = loss_fn(pred, confmaps)
        trained = [k for k in live if k not in frozen]
        g = torch.autograd.grad(loss, [live[k] for k in trained])
        new_stats = dict(batch_stats)
        for m, (mean, var) in updates.items():
            new_stats[f"{bn_names[m]}.running_mean"] = mean
            new_stats[f"{bn_names[m]}.running_var"] = var
        return loss.detach(), dict(zip(trained, g)), new_stats

    return micro


def make_grad_fn(model: nn.Module, cfg: Config) -> Callable:
    """``grads(params, data, ids, generator, batch_stats=None) -> (loss,
    {name: grad})`` of one microbatch: the train step's body before the
    update. The gradients are those of the parameters that train (frozen
    ones have none); a BatchNorm model takes its running averages.

    ``data`` is the dataset dict on the device (``box`` (N, H, W, C), and
    ``peaks`` (N, K, 2) with ``peak_vals`` (N, K), or ``confmaps``
    (N, H, W, K); the cameras ``P``, ``P_inv`` of the camera-matrix
    models); ``ids`` (B,) sample indices. With augmentation and peaks, the
    images are warped (in the compute dtype), the targets rendered at the
    moved peaks and each view's warp folded into its camera; without
    augmentation the targets are rendered at the stored peaks; with
    ``confmaps`` only, images and maps are warped together, except for a
    camera model, which is not warped."""
    micro = _microbatch_fn(model, cfg)

    def grads(params: dict, data: dict, ids, gen: torch.Generator, batch_stats=None):
        loss, g, _ = micro(params, batch_stats or {}, data, ids, gen)
        return loss, g

    return grads


def _copy_opt_state(opt_state: dict) -> dict:
    """A copy whose tensors the next update may change in place."""
    return {
        "state": {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
                  for i, s in opt_state["state"].items()},
        "param_groups": [dict(g) for g in opt_state["param_groups"]],
    }


def make_train_step(model: nn.Module, cfg: Config) -> Callable:
    """``step(state, data, idx, lr_scale=1.0) -> (state, loss)``: one Adam
    update over ``idx.shape[0]`` microbatches.

    ``data``: the dataset dict on the device (``DeviceDataset.data``, or a
    ``HostDataset.step_payload`` window); ``idx``: (accum, B) sample
    indices. The loss is the microbatches' mean, a device scalar; the
    gradients are their mean, and the update is Adam's at ``learning_rate *
    lr_scale``. Frozen parameters (:func:`frozen_names`) pass to the new
    state as they are; the running averages are the last microbatch's."""
    micro = _microbatch_fn(model, cfg)

    def train_step(state: TrainState, data: dict, idx, lr_scale: float = 1.0):
        idx = torch.as_tensor(idx, device=data["box"].device)
        accum = idx.shape[0]
        loss_sum, grad_sum = None, None
        stats = state.batch_stats
        for i in range(accum):
            gen = step_generator(state.seed, state.step, i, data["box"].device)
            loss, g, stats = micro(state.params, stats, data, idx[i], gen)
            if grad_sum is None:
                loss_sum, grad_sum = loss, g
            else:
                loss_sum = loss_sum + loss
                grad_sum = {k: grad_sum[k] + g[k] for k in grad_sum}
        params, opt_state = adam_update(
            cfg, state, {k: g / accum for k, g in grad_sum.items()}, lr_scale)
        new_state = TrainState(step=state.step + 1, params=params,
                               opt_state=opt_state, seed=state.seed,
                               batch_stats=stats)
        return new_state, loss_sum / accum

    return train_step


def adam_update(
    cfg: Config, state: TrainState, grads: dict, lr_scale: float = 1.0
) -> tuple[dict, dict]:
    """(params, opt_state) after one Adam update of ``state`` by ``grads``
    (name -> gradient of each parameter that trains) at ``learning_rate *
    lr_scale``. New tensors: the state given is left as it was; parameters
    without a gradient pass as they are."""
    return adam_step(state.params, state.opt_state, grads, cfg.learning_rate * lr_scale)


def adam_step(
    params: dict, opt_state: dict, grads: dict, lr: float
) -> tuple[dict, dict]:
    """(params, opt_state) after one ``torch.optim.Adam`` update at ``lr``
    of the parameters in ``grads``; new tensors, the arguments left as they
    were."""
    params = {k: v.detach().clone() if k in grads else v for k, v in params.items()}
    opt = torch.optim.Adam([params[k] for k in grads], lr=lr)
    opt.load_state_dict(_copy_opt_state(opt_state))
    for group in opt.param_groups:
        group["lr"] = lr
    for k, g in grads.items():
        params[k].grad = g
    opt.step()
    for k in grads:
        params[k].grad = None
    return params, opt.state_dict()


def make_eval_step(model: nn.Module, cfg: Config) -> Callable:
    """``eval(state, batch) -> (mse, l2)``: the loss of the eval forward
    (running averages, the batch's cameras) and the (B, K) pixel L2 of the
    decoded peaks (``cfg.eval_decode``), on the device
    (pytorch/train_pytorch.py:150-213)."""
    loss_fn = make_loss_fn(cfg)
    predict = make_predict_fn(model)

    def eval_step(state: TrainState, batch: dict):
        pred = predict(state.params, *model_args(batch), batch_stats=state.batch_stats)
        with torch.no_grad():
            mse = loss_fn(pred, batch["confmaps"])
            l2 = peaks.l2_distances(pred, batch["confmaps"].float(),
                                    decode=cfg.eval_decode)
        return mse, l2

    return eval_step


def make_predict_fn(model: nn.Module) -> Callable:
    """``predict(params, images, *cameras, batch_stats=None) -> maps``: the
    eval forward (no dropout, BatchNorm on ``batch_stats``, the running
    averages) of ``model`` with ``params``; the camera-matrix models take
    ``P`` and ``P_inv`` after the images."""

    def predict(params: dict, *inputs: torch.Tensor, batch_stats=None) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            return functional_call(model, {**params, **(batch_stats or {})}, inputs)

    return predict


class PlateauScheduler:
    """Host-side ReduceLROnPlateau with torch's semantics (mode 'min',
    factor, patience, relative threshold, cooldown, min_lr;
    pytorch/train_pytorch.py:112-114): emits the ``lr_scale`` the train
    step takes."""

    def __init__(self, cfg: Config):
        self.factor = cfg.reduce_lr_factor
        self.patience = cfg.reduce_lr_patience
        self.threshold = cfg.reduce_lr_min_delta
        self.cooldown = cfg.reduce_lr_cooldown
        self.min_lr = cfg.reduce_lr_min_lr
        self.base_lr = cfg.learning_rate
        self.best = float("inf")
        self.num_bad = 0
        self.cooldown_counter = 0
        self.lr = self.base_lr

    @property
    def lr_scale(self) -> float:
        return self.lr / self.base_lr

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        return self.lr_scale

    def state_dict(self) -> dict:
        return {
            "best": self.best, "num_bad": self.num_bad,
            "cooldown_counter": self.cooldown_counter, "lr": self.lr,
        }

    def load_state_dict(self, d: dict) -> None:
        self.best = d["best"]
        self.num_bad = d["num_bad"]
        self.cooldown_counter = d["cooldown_counter"]
        self.lr = d["lr"]
