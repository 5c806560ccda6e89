"""The numbers that decide ``correct``, and the control's precision.

Serving (``peak_numbers``): each served peak (x, y, val) of a frame is read
in the plain reference's float32 maps of the same frame.
``peak_gap`` is the widest gap by which the reference's map at the served
(x, y) lies below its own maximum in that channel, and ``val_err`` the
widest gap between the served val and the reference's map at the served
(x, y); both over the frame's range of reference values (max - min over
positions and channels), so a flat map and a bright one weigh alike. A
peak off the grid, or a value that is not finite, reads infinity.

Training (``train_numbers``): each step's loss against the reference's,
and per leaf the norm of the first gradient (as Adam holds it after one
step) and of the parameters' change after three steps, each gap over the
reference's norm of that leaf or of the median leaf, whichever is larger;
the worst leaf is the number. Leaves whose reference gradient is below a
thousandth of the median leaf's move by round-off alone under Adam and are
left out of the change.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TINY_GRAD = 1e-3  # of the median leaf's gradient norm


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the float8 ``dtype`` with one scale for the tensor
    (its largest magnitude onto the format's largest value), returned in
    ``t``'s dtype."""
    s = torch.finfo(dtype).max / t.abs().amax().clamp_min(1e-30)
    return (t * s).to(dtype).to(t.dtype) / s


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """An operand as an fp8 path computes it: the value rounded to float8
    e4m3, and in training the gradient that flows back through it rounded
    to float8 e5m2, each with one scale for the tensor."""
    return _FP8.apply(t)


def peak_numbers(ref_maps: torch.Tensor, served: np.ndarray, val_mode: str) -> dict:
    """``ref_maps`` (n, H, W, K) float32 on any device; ``served`` (n, 3, K)
    [x, y, val]. Returns ``{"peak_gap", "val_err"}``, the worst frame's."""
    n, h, w, k = ref_maps.shape
    pts = torch.as_tensor(np.asarray(served, np.float32), device=ref_maps.device)
    x, y, val = pts[:, 0], pts[:, 1], pts[:, 2]
    ok = (torch.isfinite(pts).all(dim=1) & (x == x.round()) & (y == y.round())
          & (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1))
    xi = x.nan_to_num(0).clamp(0, w - 1).long()
    yi = y.nan_to_num(0).clamp(0, h - 1).long()
    flat = ref_maps.reshape(n, h * w, k)
    at = torch.gather(flat, 1, (yi * w + xi)[:, None, :])[:, 0, :]  # (n, K)
    best = flat.amax(dim=1)
    rng = (flat.amax(dim=(1, 2)) - flat.amin(dim=(1, 2))).clamp_min(1e-30)[:, None]
    gap = torch.where(ok, (best - at) / rng, torch.full_like(at, math.inf))
    scale = rng if val_mode == "raw" else torch.ones_like(rng)
    err = torch.where(ok, (val - at).abs() / scale, torch.full_like(at, math.inf))
    return {"peak_gap": float(gap.max()), "val_err": float(err.max())}


def worst(*readings: dict) -> dict:
    """Each number's largest reading over ``readings``."""
    out: dict = {}
    for r in readings:
        for name, v in r.items():
            out[name] = max(out.get(name, -math.inf), v)
    return out


def _worst_leaf(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's ``|norm_prog - norm_ref| / max(norm_ref, median
    norm_ref)``."""
    names = [n for n in ref if keep is None or n in keep]
    med = float(np.median([ref[n] for n in ref]))
    gaps = [abs(prog[n] - ref[n]) / max(ref[n], med) if math.isfinite(prog[n]) else math.inf
            for n in names]
    return max(gaps, default=math.inf)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: ``{"losses": [3], "grad_norms": {leaf: norm},
    "change_norms": {leaf: norm}}``, leaves by the same names."""
    losses = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
              for p, r in zip(prog["losses"], ref["losses"])]
    g = ref["grad_norms"]
    med = float(np.median(list(g.values())))
    moved = {n for n, v in g.items() if v >= TINY_GRAD * med}
    return {"loss_gap": max(losses),
            "grad_gap": _worst_leaf(prog["grad_norms"], g),
            "change_gap": _worst_leaf(prog["change_norms"], ref["change_norms"], moved)}
