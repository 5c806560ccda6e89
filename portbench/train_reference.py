"""The plain training reference: steps of the cell's training run, in
float32 (TF32 off), on the benchmark's own copy of the raw samples at the
indices the feed handed the program's step. It follows the run's first
steps from the seeded flax-layout weights with Adam's moments at zero, and
the window's last steps from the program's own state where they began (its
parameters and moments, laid out as flax's by the family).

Each step draws from the generator the program's step draws from (a
function of seed, step and microbatch), in the program's order: the
augmentation (``portbench.augment``), then the family forward's dropout
masks. The loss is the mean squared error of the maps against the targets
rendered at the moved peaks; the gradients come from autograd; the update
is Adam's (betas 0.9 and 0.999, eps 1e-8) written out.
"""

from __future__ import annotations

import torch

from .augment import augment, step_generator
from .serving import exact_float32

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def state_name(path: str) -> str:
    """flax ``a/b/kernel`` -> the module parameter name ``a.b.weight``."""
    *scopes, leaf = path.split("/")
    return ".".join([*scopes, "weight" if leaf in ("kernel", "scale") else leaf])


def run(family, spec: dict, aug: dict, lr: float, rate: float, params: dict, pool: dict,
        indices: list, seed: int, device: torch.device, quant=lambda t: t,
        half_batch: bool = False, start: dict | None = None) -> dict:
    """``params``: path -> float32 device tensor; ``pool``: host arrays
    ``box``, ``peaks``, ``peak_vals``; ``indices``: each step's (1, B)
    sample indices. ``start``: None from the run's first step, or
    ``{"step", "exp_avg", "exp_avg_sq"}`` (moments by path) to go on from
    that step's state. Returns the losses, the first gradient's norm per
    leaf and the change's norm per leaf after the last step, by module
    name. ``half_batch``: the loss over the first half of each batch only
    (a planted fault)."""
    p = {k: v.detach().clone().float() for k, v in params.items()}
    p0 = {k: v.clone() for k, v in p.items()}
    first = start["step"] if start else 0
    m = {k: start["exp_avg"][k].detach().clone().float() if start else torch.zeros_like(v)
         for k, v in p.items()}
    v2 = {k: start["exp_avg_sq"][k].detach().clone().float() if start else torch.zeros_like(v)
          for k, v in p.items()}
    losses, grad_norms = [], {}
    for k_step, idx in enumerate(indices):
        step = first + k_step
        ids = idx[0]
        gen = step_generator(seed, step, 0, device)
        box = torch.from_numpy(pool["box"][ids]).to(device)
        pk = torch.from_numpy(pool["peaks"][ids]).to(device)
        pv = torch.from_numpy(pool["peak_vals"][ids]).to(device)
        with exact_float32():
            box, target = augment(gen, box, pk, pv, aug)
            leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
            pred = family.forward(leaves, box, spec, quant, gen, rate)
            if half_batch:
                pred, target = pred[: pred.shape[0] // 2], target[: target.shape[0] // 2]
            loss = torch.square(pred - target).mean()
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        if k_step == 0:
            grad_norms = {state_name(k): float(g.norm()) for k, g in grads.items()}
        t = step + 1
        with torch.no_grad():
            for k, g in grads.items():
                m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
                v2[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                denom = (v2[k].sqrt() / (1 - BETA2 ** t) ** 0.5).add_(EPS)
                p[k] = p[k] - (lr / (1 - BETA1 ** t)) * m[k] / denom
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": {state_name(k): float((p[k] - p0[k]).norm()) for k in p}}
