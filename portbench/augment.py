"""The training augmentation for the plain training reference: the draws
the program's step makes, and the warp and targets worked out from their
definitions in float64.

The draws (``step_generator``, ``_sample_params``, the bucket index) are
the order in which the step takes its random numbers from its generator,
so that both sides warp by the same matrices and drop the same units; they
follow the JAX package's ``train/loop.py`` and ``ops/affine.py``
(``augment_views_and_peaks``, ``sample_augment_params``,
``rotation_buckets``) as the port's step consumes them. Everything computed
from the draws is this file's own: the forward matrices in float64, their
inverse by ``torch.linalg.inv``, and the separable warp as the JAX package
defines it (``affine_warp_separable_batch``): an optional 90-degree turn,
then along rows a fractional shift by ``q (y - cy)`` and a resample at
``p x + r + q cy``, then along columns a resample at ``a11 y + t1 + a10 cy``
and a fractional shift by ``g (x - cy)``, each a one-dimensional
Catmull-Rom interpolation (a = -0.5) of the pass before with zeros outside
it, on canvases wide enough that nothing is cut. The targets are Gaussians
at the peaks moved by the forward matrices.
"""

from __future__ import annotations

import numpy as np
import torch

_BUCKET_MIN_HEIGHT = 96


def step_generator(seed: int, step: int, microbatch: int, device) -> torch.Generator:
    """The generator of one microbatch's draws, from (seed, step,
    microbatch) only."""
    s = np.random.SeedSequence([seed, step, microbatch]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def _rand(n: int, gen: torch.Generator) -> torch.Tensor:
    return torch.rand((n,), generator=gen, device=gen.device)


def _sample_params(gen, batch, rotation_range, xy_shifts, zoom_range, flip_h_on, flip_v_on,
                   rotation_low, quadrants):
    def uniform(lo, hi):
        return lo + (hi - lo) * _rand(batch, gen)

    def coin():
        return _rand(batch, gen) < 0.5

    if rotation_low > 0.0 or quadrants:
        angle = uniform(rotation_low, rotation_range)
        angle = torch.where(coin(), angle, -angle)
        if quadrants:
            angle = angle + 90.0 * torch.randint(0, 4, (batch,), generator=gen,
                                                 device=gen.device).float()
    else:
        angle = uniform(-rotation_range, rotation_range)
    scale = uniform(zoom_range[0], zoom_range[1])
    shift_x = uniform(-xy_shifts, xy_shifts)
    shift_y = uniform(-xy_shifts, xy_shifts)
    flip_h = coin() & flip_h_on
    flip_v = coin() & flip_v_on
    return angle, scale, shift_x, shift_y, flip_h, flip_v


def _buckets(rotation_range: float):
    """The rotation buckets a step draws one of before its parameters, or
    None where it draws none."""
    r = abs(float(rotation_range))
    if r <= 20.0:
        return None
    if r <= 45.0:
        dom, quad = r, False
    elif r == 180.0:
        dom, quad = 45.0, True
    else:
        return None
    return [(0.0, dom / 3.0, quad), (dom / 3.0, 2.0 * dom / 3.0, quad),
            (2.0 * dom / 3.0, dom, quad)]


def forward_matrices(angle, scale, shift_x, shift_y, flip_h, flip_v, h, w) -> torch.Tensor:
    """(B, 3, 3) float64: flip, then zoom about the centre, then shift, then
    rotation by ``angle`` degrees about the centre."""
    a = angle.double()
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    one, zero = torch.ones_like(a), torch.zeros_like(a)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    fh, fv = flip_h.double(), flip_v.double()
    flip = mat([[1.0 - 2.0 * fh, zero, fh * (w - 1)], [zero, 1.0 - 2.0 * fv, fv * (h - 1)],
                [zero, zero, one]])
    s = scale.double()
    zoom = mat([[s, zero, cx * (1.0 - s)], [zero, s, cy * (1.0 - s)], [zero, zero, one]])
    shift = mat([[one, zero, shift_x.double()], [zero, one, shift_y.double()],
                 [zero, zero, one]])
    t = torch.deg2rad(a)
    c, sn = torch.cos(t), torch.sin(t)
    rot = mat([[c, sn, cx - c * cx - sn * cy], [-sn, c, cy + sn * cx - c * cy],
               [zero, zero, one]])
    return rot @ shift @ zoom @ flip


def _catmull_rom(d: torch.Tensor) -> torch.Tensor:
    ad = d.abs()
    near = 1.5 * ad**3 - 2.5 * ad**2 + 1.0
    far = -0.5 * (ad**3 - 5.0 * ad**2 + 8.0 * ad - 4.0)
    return torch.where(ad < 1.0, near, torch.where(ad < 2.0, far, torch.zeros_like(ad)))


def sample_rows(rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``rows`` (N, L, C), ``pos`` (N, J) in index units -> (N, J, C): each
    row interpolated at its positions by the four Catmull-Rom taps around
    each, zero outside ``[0, L)``."""
    n, length, c = rows.shape
    base = torch.floor(pos)
    out = torch.zeros((n, pos.shape[1], c), dtype=rows.dtype, device=rows.device)
    for d in (-1, 0, 1, 2):
        t = base + d
        wt = _catmull_rom(pos - t) * ((t >= 0) & (t <= length - 1))
        idx = t.clamp(0, length - 1).long()[..., None].expand(-1, -1, c)
        out += wt[..., None] * torch.gather(rows, 1, idx)
    return out


def _along_rows(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(B, R, L, C) sampled along its last spatial axis at ``pos`` (B, R, J)."""
    b, r, length, c = x.shape
    return sample_rows(x.reshape(b * r, length, c), pos.reshape(b * r, -1)).reshape(
        b, r, -1, c)


def warp_separable(images: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) square images inverse-warped by the forward matrices
    ``mats`` (B, 3, 3), zero border, in float64."""
    b, h, w, c = images.shape
    dev = images.device
    x = images.double()
    inv = torch.linalg.inv(mats.double())
    # a quarter turn where the row shear would exceed 1: img90[y, x] =
    # img[x, w-1-y], warped by G^-1 @ inv with G^-1 = [[0, 1, 0], [-1, 0, w-1]]
    use90 = inv[:, 0, 1].abs() > inv[:, 1, 1].abs()
    g_inv = torch.tensor([[0.0, 1.0, 0.0], [-1.0, 0.0, w - 1.0], [0.0, 0.0, 1.0]],
                         dtype=torch.float64, device=dev)
    x = torch.where(use90[:, None, None, None], x.transpose(1, 2).flip(1), x)
    iv = torch.where(use90[:, None, None], g_inv @ inv, inv)
    a00, a01, t0 = iv[:, 0, 0], iv[:, 0, 1], iv[:, 0, 2]
    a10, a11, t1 = iv[:, 1, 0], iv[:, 1, 1], iv[:, 1, 2]
    a11 = torch.where(a11.abs() < 1e-6, torch.full_like(a11, 1e-6), a11)
    q, g = a01 / a11, a10 / a11
    p, r = a00 - q * a10, t0 - q * t1
    cy = (h - 1) / 2.0
    m = w  # canvas margin: |q|, |g| <= 1 keep every shift under cy

    def ar(lo, hi):
        return torch.arange(lo, hi, dtype=torch.float64, device=dev)

    ys, xo, canvas = ar(0, h) - cy, ar(0, w), ar(-m, w + m)
    # rows: shift onto the canvas, then resample at p x + r + q cy
    x = _along_rows(x, canvas[None, None, :] + (q[:, None] * ys)[:, :, None])
    pos = (p[:, None] * xo + (r + q * cy)[:, None] + m)[:, None, :].expand(b, h, w)
    x = _along_rows(x, pos).transpose(1, 2)  # (B, W, H, C): columns as rows
    # columns: resample onto the canvas at a11 y + t1 + a10 cy, then shift
    pos = (a11[:, None] * canvas + (t1 + a10 * cy)[:, None])[:, None, :].expand(b, w, -1)
    x = _along_rows(x, pos)
    pos = ar(0, h)[None, None, :] + (g[:, None] * (xo - cy))[:, :, None] + m
    return _along_rows(x, pos).transpose(1, 2)


def confmaps(peaks_xy: torch.Tensor, h: int, w: int, sigma: float) -> torch.Tensor:
    """(N, K, 2) [x, y] -> (N, H, W, K) Gaussians of ``sigma``, in the
    peaks' dtype."""
    xs = torch.arange(w, dtype=peaks_xy.dtype, device=peaks_xy.device)
    ys = torch.arange(h, dtype=peaks_xy.dtype, device=peaks_xy.device)
    dx2 = torch.square(xs - peaks_xy[..., 0:1])
    dy2 = torch.square(ys - peaks_xy[..., 1:2])
    d2 = dy2[..., :, None] + dx2[..., None, :]
    return torch.exp(-d2 / (2.0 * sigma**2)).permute(0, 2, 3, 1)


def augment(gen: torch.Generator, images: torch.Tensor, peaks_xy: torch.Tensor,
            peak_vals: torch.Tensor, aug: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """One view per sample: the warped images and the targets rendered at
    the moved peaks, times their vals, both float32 (worked out in
    float64). ``aug``: the ``Config`` fields (``rotation_range``,
    ``xy_shifts``, ``zoom_range``, ``horizontal_flip``, ``vertical_flip``,
    ``sigma``); no shear."""
    b, h, w, _ = images.shape
    rr = aug["rotation_range"]
    buckets = _buckets(rr) if h >= _BUCKET_MIN_HEIGHT else None
    if buckets:
        low, high, quad = buckets[int(torch.randint(0, len(buckets), (), generator=gen,
                                                    device=gen.device))]
    else:
        low, high, quad = 0.0, rr, False
    params = _sample_params(gen, b, high, aug["xy_shifts"], tuple(aug["zoom_range"]),
                            aug["horizontal_flip"], aug["vertical_flip"], low, quad)
    mats = forward_matrices(*params, h, w)
    warped = warp_separable(images, mats)
    ones = torch.ones((*peaks_xy.shape[:-1], 1), dtype=torch.float64, device=peaks_xy.device)
    moved = torch.einsum("bij,bkj->bki", mats, torch.cat([peaks_xy.double(), ones], -1))
    maps = confmaps(moved[..., :2], h, w, aug["sigma"]) * peak_vals.double()[:, None, None, :]
    return warped.float(), maps.float()
