"""Training steps through ``train.loop.make_train_step``, one after another.

The pool is ``pool_samples`` seeded uniform float32 frames, each scaled by
a gain drawn log-uniformly from ``gain_range`` (exposure differs from frame
to frame, so samples weigh differently in a batch's loss), with seeded
peaks (one a map, ``margin`` pixels or more inside the frame, val 1, or 0
for an absent keypoint at ``absent_share``), built straight into the port's
``DeviceDataset`` (``Config().val_fraction`` of it held out). Set-up builds
one ``TrainState`` from the seeded weights and drives the step through its
first ``reference_steps`` steps with the dataset's own index ring; the
window goes on from that state, re-shuffling the ring each epoch as the
trainer does, and closes on a synchronise. The step returns a new state and
leaves the one it was given as it was, so the window keeps the states its
last ``reference_steps`` steps began from at no cost.
``correct``: the plain reference (``portbench.train_reference``) follows
the first steps from the same weights, samples and indices (``loss_gap``,
``grad_gap``, ``change_gap``), and the window's last steps from the
program's state where they began (the same numbers, ``window_`` before
each name).
"""

from __future__ import annotations

import gc
from collections import deque

import numpy as np
import torch
from torch.autograd.profiler import record_function

from .. import compare, program, train_reference
from ..weights import POOL, generator, make_tree, seed_stream, ORDER


def _pool(t: dict, spec: dict, seed: int, device: torch.device) -> dict:
    n, k = t["pool_samples"], spec["out_channels"]
    h, w, c = spec["image_shape"]
    gen = generator(seed, POOL, device)
    lo, hi = np.log(t["gain_range"])
    gain = torch.exp(lo + (hi - lo) * torch.rand((n, 1, 1, 1), generator=gen, device=device))
    box = torch.rand((n, h, w, c), generator=gen, device=device) * gain
    m = t["margin"]
    peaks = m + torch.rand((n, k, 2), generator=gen, device=device) * (w - 1 - 2 * m)
    vals = (torch.rand((n, k), generator=gen, device=device) >= t["absent_share"]).float()
    return {"box": box.cpu().numpy(), "peaks": peaks.cpu().numpy(),
            "peak_vals": vals.cpu().numpy()}


class Driver:
    def __init__(self, ctx):
        from pose_estimation_amitai_torch import weights as port_weights
        from pose_estimation_amitai_torch.data.pipeline import DeviceDataset
        from pose_estimation_amitai_torch.models import build_model
        from pose_estimation_amitai_torch.train import loop

        spec, t = ctx.spec, ctx.traffic
        self.ctx = ctx
        self.batch = t["batch"]
        self.cfg = program.port_config(spec, batch_size=self.batch)
        self.tree, self.ref_params = make_tree(ctx.family.leaves(spec), ctx.seed, ctx.device)
        self.pool = _pool(t, spec, ctx.seed, ctx.device)
        self.ds = DeviceDataset(self.cfg, self.pool, seed=seed_stream(ctx.seed, ORDER),
                                device=ctx.device)
        self.per_epoch = len(self.ds.train_inds) // self.batch
        with torch.device("meta"):
            model = build_model(self.cfg, tuple(spec["image_shape"]), spec["out_channels"])
        params = {k: v.to(ctx.device) for k, v in
                  port_weights.flax_to_state_dict(self.tree, model).items()}
        opt_state = loop.create_optimizer(self.cfg, list(params.values())).state_dict()
        self.state = loop.TrainState(step=0, params=params, opt_state=opt_state,
                                     seed=ctx.seed)
        self.names, self.theta0 = list(params), params
        self.step = loop.make_train_step(model, self.cfg)
        self.steps = 0
        self.indices, self.losses = [], []
        for _ in range(t["reference_steps"]):
            self.indices.append(self._feed())
            self.state, loss = self.step(self.state, self.ds.data, self.indices[-1])
            self.losses.append(loss)
            if len(self.losses) == 1:
                self.state1 = self.state
        self.state_n = self.state
        self.recent: deque = deque(maxlen=t["reference_steps"])
        self.sync()

    def _feed(self) -> np.ndarray:
        if self.steps and self.steps % self.per_epoch == 0:
            self.ds.shuffle_train_indices()
        self.steps += 1
        return self.ds.step_indices(self.batch, 1)

    def unit(self) -> int:
        idx = self._feed()
        before = self.state
        with record_function("portbench.train_step"):
            self.state, loss = self.step(self.state, self.ds.data, idx)
        self.recent.append((before, idx, loss))
        return self.batch

    def sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def end_to_end(self, window_s: float, useful: int) -> dict:
        return {"train_samples_per_s": useful / window_s}

    def work(self) -> dict:
        return {"kind": "train",
                "flops_per_useful": 3.0 * self.ctx.family.flops_per_frame(self.ctx.spec),
                "kernel_bounds": {}}

    def _moment(self, state, key: str) -> list:
        """Adam's ``key`` of each parameter, in ``self.names``' order."""
        opt = state.opt_state["state"]
        return [opt[i][key] for i in range(len(self.names))]

    def release(self) -> None:
        """Keep the program's readings (each stretch's losses, its first
        gradient as Adam holds it, its change) and the state the window's
        stretch began from; free the rest."""
        names = self.names
        b1 = train_reference.BETA1
        avg1 = self._moment(self.state1, "exp_avg")
        self.prog = {
            "losses": [float(x) for x in self.losses],
            "grad_norms": {n: float(avg1[i].norm()) / (1 - b1) for i, n in enumerate(names)},
            "change_norms": {n: float((self.state_n.params[n] - self.theta0[n]).norm())
                             for n in names},
        }
        steps = list(self.recent)
        first = steps[0][0]
        after = [s for s, _, _ in steps[1:]] + [self.state]
        avg0, avg1 = self._moment(first, "exp_avg"), self._moment(after[0], "exp_avg")
        self.prog_window = {
            "losses": [float(loss) for _, _, loss in steps],
            "grad_norms": {n: float((avg1[i] - b1 * avg0[i]).norm()) / (1 - b1)
                           for i, n in enumerate(names)},
            "change_norms": {n: float((self.state.params[n] - first.params[n]).norm())
                             for n in names},
        }
        by_name = {train_reference.state_name(p): p for p in self.ref_params}

        def leaf(name, t):
            return self.ctx.family.flax_leaf(by_name[name], t).detach().clone()

        self.window_start = {
            "params": {by_name[n]: leaf(n, first.params[n]) for n in names},
            "start": {"step": int(first.step),
                      "exp_avg": {by_name[n]: leaf(n, avg0[i]) for i, n in enumerate(names)},
                      "exp_avg_sq": {by_name[n]: leaf(n, m) for n, m in
                                     zip(names, self._moment(first, "exp_avg_sq"))}},
        }
        self.window_indices = [idx for _, idx, _ in steps]
        self.recent.clear()
        self.ds = self.state = self.state1 = self.state_n = self.step = self.theta0 = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, window: bool = False, **kw) -> dict:
        c = self.cfg
        aug = dict(rotation_range=c.rotation_range, xy_shifts=c.xy_shifts,
                   zoom_range=c.zoom_range, horizontal_flip=c.horizontal_flip,
                   vertical_flip=c.vertical_flip, sigma=c.sigma)
        if window:
            params, indices = self.window_start["params"], self.window_indices
            kw["start"] = self.window_start["start"]
        else:
            params, indices = self.ref_params, self.indices
        return train_reference.run(
            self.ctx.family, self.ctx.spec, aug, c.learning_rate, c.dropout_ratio,
            params, self.pool, indices, self.ctx.seed, self.ctx.device, **kw)

    def _numbers(self, first: dict, window: dict) -> dict:
        """Both stretches' numbers; of the window's, the cell compares the
        loss alone (PERF.md: late in a run the gradients of the stated
        bfloat16 part from float32's by rounding)."""
        return {**compare.train_numbers(first, self._reference()),
                **{f"window_{k}": v for k, v in
                   compare.train_numbers(window, self._reference(window=True)).items()}}

    def numbers(self) -> dict:
        return self._numbers(self.prog, self.prog_window)

    def control_numbers(self) -> dict:
        """The reference computed in fp8, put in the program's place."""
        return self._numbers(self._reference(quant=compare.fp8),
                             self._reference(window=True, quant=compare.fp8))

    def fault_numbers(self) -> dict:
        """Readings of a planted fault: half of each batch left out, the
        mean taken over the rest, in the reference put in the program's
        place."""
        return self._numbers(self._reference(half_batch=True),
                             self._reference(window=True, half_batch=True))
