"""On-device affine augmentation (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/ops/affine.py`` (reference:
pytorch/Augmentor.py:31-43, 96-103; tensorflow/simple_data_generator.py:72-95):
the flip -> scale -> shift -> rotate chain is composed into one 3x3 matrix
per sample, and the images are inverse-warped by it; reads outside the
image are 0 (cv2 BORDER_CONSTANT 0). Two warps, as in JAX:

* ``method="separable"``, the default of every ``augment_*`` function and
  so of training: an optional rot90 pre-transform, then two passes (x, then
  y), each a per-row fractional shift and a per-frame uniform resample,
  with Catmull-Rom taps whatever the order (bilinear passes smooth the
  image four times over). Wide-rotation draws are split into canvas
  buckets (:func:`rotation_buckets`), one bucket a call;
* ``method="exact"``: a gather of each output pixel's 2 x 2 (bilinear,
  order <= 1) or 4 x 4 (Catmull-Rom, a = -0.5, order >= 2) source taps.

The cubic weights are written out here because ``grid_sample(mode="bicubic")``
uses a = -0.75.

Random draws come from an explicit ``torch.Generator`` on the images'
device: the train step derives one from (seed, step, microbatch).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import draws
from .gaussian import confmaps_from_peaks


class AugmentParams(NamedTuple):
    """Per-sample augmentation parameters, each shaped (B,)."""

    angle_deg: torch.Tensor
    scale: torch.Tensor
    shift_x: torch.Tensor
    shift_y: torch.Tensor
    flip_h: torch.Tensor  # bool
    flip_v: torch.Tensor  # bool
    shear_deg: torch.Tensor | None = None  # keras ImageDataGenerator shear


_METHODS = ("separable", "exact")
_BUCKET_MIN_HEIGHT = 96  # below this a bucket's narrower canvas saves a few pixels


def _check_method(method: str) -> None:
    if method not in _METHODS:
        raise ValueError(f"method={method!r}; expected one of {_METHODS}")


def sample_augment_params(
    generator: torch.Generator,
    batch: int,
    rotation_range: float = 30.0,
    xy_shifts: float = 10.0,
    zoom_range: tuple[float, float] = (1.0, 1.0),
    do_horizontal_flip: bool = True,
    do_vertical_flip: bool = True,
    shear_range: float = 0.0,
    rotation_low: float = 0.0,
    quadrants: bool = False,
) -> AugmentParams:
    """Draw per-sample parameters on the generator's device: angle uniform
    in +-rotation_range, scale uniform in zoom_range, shifts uniform in
    +-xy_shifts, Bernoulli(0.5) flips gated by the switches, keras shear
    uniform in +-shear_range (tensorflow/simple_data_generator.py:72-95,
    pytorch/Datagenerators.py:169-185, tensorflow/Augmentor.py:44).

    ``rotation_low`` / ``quadrants`` serve the canvas buckets
    (:func:`rotation_buckets`): the angle's magnitude is uniform in
    [rotation_low, rotation_range] with a random sign, and ``quadrants``
    adds a uniform multiple of 90 degrees."""

    def uniform(lo: float, hi: float) -> torch.Tensor:
        u = draws.rand((batch,), generator, generator.device)
        return lo + (hi - lo) * u

    def coin() -> torch.Tensor:
        return draws.rand((batch,), generator, generator.device) < 0.5

    if rotation_low > 0.0 or quadrants:
        angle = uniform(rotation_low, rotation_range)
        angle = torch.where(coin(), angle, -angle)
        if quadrants:
            angle = angle + 90.0 * draws.randint(4, (batch,), generator,
                                                 generator.device).float()
    else:
        angle = uniform(-rotation_range, rotation_range)
    scale = uniform(zoom_range[0], zoom_range[1])
    shift_x = uniform(-xy_shifts, xy_shifts)
    shift_y = uniform(-xy_shifts, xy_shifts)
    flip_h = coin() & do_horizontal_flip
    flip_v = coin() & do_vertical_flip
    shear = uniform(-shear_range, shear_range) if shear_range > 0 else None
    return AugmentParams(angle, scale, shift_x, shift_y, flip_h, flip_v, shear)


def make_affine_matrix(
    params: AugmentParams, height: int, width: int
) -> torch.Tensor:
    """(B, 3, 3) float32 forward matrices mapping input pixel (x, y, 1) to
    output coordinates: horizontal flip, vertical flip, scale about the
    centre, shift, rotation about the centre (clockwise in y-down
    coordinates for a positive angle, as scipy.ndimage.rotate), then the
    optional keras shear about the centre (pytorch/Augmentor.py:11-43)."""
    angle = params.angle_deg.float()
    cx = (width - 1) / 2.0
    cy = (height - 1) / 2.0
    one = torch.ones_like(angle)
    zero = torch.zeros_like(angle)

    def mat(rows) -> torch.Tensor:
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    fh = params.flip_h.float()
    fv = params.flip_v.float()
    flip = mat([[1.0 - 2.0 * fh, zero, fh * (width - 1)],
                [zero, 1.0 - 2.0 * fv, fv * (height - 1)],
                [zero, zero, one]])
    s = params.scale.float()
    scale = mat([[s, zero, cx * (1.0 - s)],
                 [zero, s, cy * (1.0 - s)],
                 [zero, zero, one]])
    shift = mat([[one, zero, params.shift_x.float()],
                 [zero, one, params.shift_y.float()],
                 [zero, zero, one]])
    theta = torch.deg2rad(angle)
    c, sn = torch.cos(theta), torch.sin(theta)
    rot = mat([[c, sn, cx - c * cx - sn * cy],
               [-sn, c, cy + sn * cx - c * cy],
               [zero, zero, one]])
    out = rot @ shift @ scale @ flip
    if params.shear_deg is not None:
        # keras apply_affine_transform: x' = x - sin(s)(y - cy); y' = cos(s)(y - cy) + cy
        sh = torch.deg2rad(params.shear_deg.float())
        ssin, scos = torch.sin(sh), torch.cos(sh)
        out = out @ mat([[one, -ssin, ssin * cy],
                         [zero, scos, cy * (1.0 - scos)],
                         [zero, zero, one]])
    return out


def _taps(order: int) -> tuple[int, ...]:
    """Offsets of the source taps around ``floor`` of a sample position."""
    return (0, 1) if order <= 1 else (-1, 0, 1, 2)


def _kernel_weights(d: torch.Tensor, order: int) -> torch.Tensor:
    """The interpolation kernel at distances ``d``: the linear hat for
    order <= 1, Catmull-Rom (Keys a = -0.5) otherwise."""
    ad = d.abs()
    if order <= 1:
        return (1.0 - ad).clamp_min(0.0)
    a = -0.5
    ad2, ad3 = ad * ad, ad * ad * ad
    near = (a + 2.0) * ad3 - (a + 3.0) * ad2 + 1.0
    far = a * (ad3 - 5.0 * ad2 + 8.0 * ad - 4.0)
    return torch.where(ad < 1.0, near, torch.where(ad < 2.0, far, torch.zeros_like(ad)))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add (the
    float64 product of two float32 values is exact)."""
    return (a.double() * b + c).float()


def _inverse(m: torch.Tensor) -> torch.Tensor:
    """Float32 inverse of (B, 3, 3) affine matrices (last row 0, 0, 1, as
    :func:`make_affine_matrix` makes them), computed as LAPACK's getrf and
    trsm compute a 3x3 inverse: LU with partial pivoting (the first largest
    pivot), the column scaled by the pivot's reciprocal, then the two
    triangular solves column by column with fused updates and reciprocal
    diagonals. For an affine matrix the one pivot choice is between the
    first two rows, and the rest reduces to the operations below. A source
    coordinate of a 192-px frame is ~200, where one ulp moves a sharp image
    by ~2e-5: this arithmetic gives ``jnp.linalg.inv``'s bits on any device
    (``torch.linalg.inv`` is a few ulps off)."""
    m = m.float()
    swap = m[:, 1, 0].abs() > m[:, 0, 0].abs()
    pa, pb, pc = torch.where(swap[:, None], m[:, 1], m[:, 0]).unbind(-1)  # pivot row
    oa, ob, oc = torch.where(swap[:, None], m[:, 0], m[:, 1]).unbind(-1)
    r0 = 1.0 / pa
    low = oa * r0
    r1 = 1.0 / (ob - low * pb)
    # row 1 of the inverse, by the column of the pivot row, the other row, 2
    y_piv, y_oth, y2 = -low * r1, r1, -(oc - low * pc) * r1
    x_piv = _fma(-pb, y_piv, 1.0) * r0
    x_oth = (-pb * y_oth) * r0
    x2 = _fma(-pb, y2, -pc) * r0
    row0 = torch.stack([torch.where(swap, x_oth, x_piv), torch.where(swap, x_piv, x_oth), x2], -1)
    row1 = torch.stack([torch.where(swap, y_oth, y_piv), torch.where(swap, y_piv, y_oth), y2], -1)
    row2 = torch.zeros_like(row0)
    row2[:, 2] = 1.0
    return torch.stack([row0, row1, row2], 1)


def affine_warp_batch(
    images: torch.Tensor, forward_matrices: torch.Tensor, order: int = 1
) -> torch.Tensor:
    """Inverse-warp (B, H, W, C) images by (B, 3, 3) forward matrices.

    Each output pixel is the weighted sum of its source taps (2 x 2
    bilinear for order <= 1, 4 x 4 Catmull-Rom otherwise), all channels
    gathered at once, computed in float32 and returned in the images'
    dtype; taps outside the image weigh 0."""
    b, h, w, c = images.shape
    dev = images.device
    inv = _inverse(forward_matrices)[:, :, :, None, None]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    src_x = inv[:, 0, 0] * xs + inv[:, 0, 1] * ys + inv[:, 0, 2]  # (B, H, W)
    src_y = inv[:, 1, 0] * xs + inv[:, 1, 1] * ys + inv[:, 1, 2]
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    tx = src_x - x0
    ty = src_y - y0
    taps = _taps(order)
    wx = [_kernel_weights(tx - t, order) for t in taps]
    wy = [_kernel_weights(ty - t, order) for t in taps]

    flat = images.float().reshape(b, h * w, c)
    out = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
    for j, dy in enumerate(taps):
        yi = y0 + dy
        for i, dx in enumerate(taps):
            xi = x0 + dx
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            lin = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
            idx = lin.reshape(b, h * w, 1).expand(-1, -1, c)
            sample = torch.gather(flat, 1, idx).reshape(b, h, w, c)
            weight = torch.where(valid, wy[j] * wx[i], torch.zeros_like(tx))
            out = out + weight[..., None] * sample
    return out.to(images.dtype)


def affine_warp(
    image: torch.Tensor, forward_matrix: torch.Tensor, order: int = 1
) -> torch.Tensor:
    """:func:`affine_warp_batch` of one (H, W, C) image by one (3, 3) matrix."""
    return affine_warp_batch(image[None], forward_matrix[None], order)[0]


def _shear_limit(rotation_range: float, shear_range: float = 0.0) -> float:
    """Bound on the separable warp's shear coefficients for a rotation
    (plus keras shear) range in degrees: tan of the rot90-normalised angle,
    with a margin. It sizes the widened intermediate canvases."""
    deg = min(abs(float(rotation_range)) + abs(float(shear_range)), 45.0)
    return min(1.0, float(np.tan(np.deg2rad(deg))) * 1.01 + 0.01)


def rotation_buckets(
    rotation_range: float, shear_range: float = 0.0
) -> list[tuple[float, float, bool]] | None:
    """The angle magnitude's draw split into three equal thirds,
    ``[(low_deg, high_deg, quadrants), ...]``, or None.

    A call draws one bucket for its whole batch and warps on that bucket's
    canvas, so a mild draw pays a narrow canvas; each sample's angle stays
    uniform over the whole range. None where bucketing cannot help or be
    exact: ranges up to 20 degrees, partial turns other than 180 degrees
    (a uniform +-200 draw modulo 360 is not uniform on the circle), and
    keras shear. A full turn is a uniform quadrant (absorbed exactly by the
    rot90 pre-transform) plus a +-45 degree residual."""
    r = abs(float(rotation_range))
    if shear_range or r <= 20.0:
        return None
    if r <= 45.0:
        dom, quad = r, False
    elif r == 180.0:
        dom, quad = 45.0, True
    else:
        return None
    return [(0.0, dom / 3.0, quad), (dom / 3.0, 2.0 * dom / 3.0, quad),
            (2.0 * dom / 3.0, dom, quad)]


def _row_fractional_shift(
    images: torch.Tensor,
    offsets: torch.Tensor,
    order: int,
    out_width: int | None = None,
    out_origin: int = 0,
    max_offset: int | None = None,
) -> torch.Tensor:
    """Per-row fractional x-shift of (B, H, W, C) images by (B, H) offsets
    ``o``: ``out[b, y, j] = sum_t k(o - t) img[b, y, j + out_origin + t]``
    for j in [0, out_width), k the interpolation kernel, reads outside the
    image 0.

    The shift covers ``|o|`` up to ``max_offset`` (default W/2 + 1) as JAX's
    radix-K form does: the taps t summed are [K*c + lo, K*c + hi] around
    ``c = floor(o / K)`` clipped to its coarse range, so a larger offset
    loses the taps beyond that range, as in JAX. One gather reads every
    row's 2 (linear) or 4 (cubic) taps from per-row starts; the sum is taken
    in float32 over weights rounded to the images' dtype and rounded once
    to it."""
    b, h, w, c = images.shape
    w_out = w if out_width is None else out_width
    radix = min(14, max(2, w // 8))
    omax = (w // 2 + 1) if max_offset is None else max(int(max_offset), 1)
    cmax = omax // radix + 1
    lo, hi = (0, radix) if order <= 1 else (-1, radix + 2)
    first, last = -cmax * radix + lo, cmax * radix + hi  # every t any row may sum
    left = max(0, -(out_origin + first))
    right = max(0, w_out - 1 + out_origin + last - (w - 1))
    rows = torch.nn.functional.pad(images, (0, 0, left, right)).reshape(
        b * h, w + left + right, c)
    offsets = offsets.float().reshape(b * h, 1)
    coarse = torch.floor(offsets / radix).clamp(-cmax, cmax) * radix
    taps = _taps(order)
    t = torch.floor(offsets) + torch.arange(
        taps[0], taps[-1] + 1, dtype=torch.float32, device=images.device)  # (B*H, taps)
    wt = torch.where((t >= coarse + lo) & (t <= coarse + hi),
                     _kernel_weights(offsets - t, order), torch.zeros_like(t))
    cols = torch.arange(w_out, device=images.device) + (out_origin + left)
    idx = (t.clamp(first, last).long()[:, None, :] + cols[None, :, None]).reshape(b * h, -1)
    read = torch.gather(rows, 1, idx[..., None].expand(-1, -1, c)).reshape(
        b * h, w_out, len(taps), c)
    out = torch.einsum("nwtc,nt->nwc", read.float(), wt.to(images.dtype).float())
    return out.reshape(b, h, w_out, c).to(images.dtype)


def _row_resample(
    images: torch.Tensor,
    stride: torch.Tensor,
    offset: torch.Tensor,
    order: int,
    out_width: int | None = None,
) -> torch.Tensor:
    """Per-frame uniform 1-D resample along x of (B, H, W, C) images:
    ``out[b, .., xo] = img[b, .., u]``, ``u = stride[b] * xo + offset[b]``
    in input-index space, as a dense (W x out_width) kernel matrix per
    frame (taps outside the image weigh 0). Accumulated in float32 over
    weights rounded to the images' dtype, rounded once to it."""
    b, h, w, c = images.shape
    w_out = w if out_width is None else out_width
    dev = images.device
    xo = torch.arange(w_out, dtype=torch.float32, device=dev)
    u = _fma(stride[:, None], xo[None, :], offset[:, None])  # (B, w_out)
    xi = torch.arange(w, dtype=torch.float32, device=dev)
    kmat = _kernel_weights(xi[None, :, None] - u[:, None, :], order)
    kmat = kmat.to(images.dtype).float()
    return torch.einsum("bhxc,bxX->bhXc", images.float(), kmat).to(images.dtype)


def affine_warp_separable_batch(
    images: torch.Tensor,
    forward_matrices: torch.Tensor,
    order: int = 1,
    shear_limit: float = 1.0,
) -> torch.Tensor:
    """Separable inverse warp of (B, H, W, C) images by (B, 3, 3) forward
    matrices, zero border, in the images' dtype; JAX's
    ``affine_warp_separable_batch``.

    The inverse ``src_x = a00 xo + a01 yo + t0``, ``src_y = a10 xo + a11 yo
    + t1`` is split in two passes: along x a per-row shift by
    ``q (y - cy)``, q = a01 / a11, onto a canvas widened by ``e`` on each
    side, then a resample of stride ``a00 - q a10``; along y (transposed) a
    resample of stride a11 onto a widened canvas, then a per-column shift
    by ``(a10 / a11) (x - cy)``. A sample whose ``|a01| > |a11|`` is first
    turned by 90 degrees (a transpose and a flip, exact), which bounds both
    shears by 1. ``shear_limit`` is the caller's bound on them (tan of the
    rotation range) and sizes ``e``. Every pass interpolates by
    Catmull-Rom whatever ``order``; integer shifts, flips and the rot90
    branch stay exact. A non-square input takes the gather warp."""
    bsz, h, w, c = images.shape
    if h != w:
        return affine_warp_batch(images, forward_matrices, order)
    dev = images.device
    inv = _inverse(forward_matrices)
    # img90[y2, x2] = img[x2, W-1-y2]: (x, y) = G (x2, y2), exact
    use90 = inv[:, 0, 1].abs() > inv[:, 1, 1].abs()
    inv90 = torch.stack([inv[:, 1], (w - 1) * inv[:, 2] - inv[:, 0], inv[:, 2]], dim=1)
    img90 = images.transpose(1, 2).flip(1)
    x = torch.where(use90[:, None, None, None], img90, images)
    iv = torch.where(use90[:, None, None], inv90, inv)

    a00, a01, t0 = iv[:, 0, 0], iv[:, 0, 1], iv[:, 0, 2]
    a10, a11, t1 = iv[:, 1, 0], iv[:, 1, 1], iv[:, 1, 2]
    safe_a11 = torch.where(a11.abs() < 1e-6, torch.full_like(a11, 1e-6), a11)
    q = a01 / safe_a11
    p = _fma(-q, a10, a00)
    r = _fma(-q, t1, t0)

    o = max(int(order), 3)
    cy = (h - 1) / 2.0
    lim = float(min(max(shear_limit, 1e-3), 1.0))
    e = int(np.ceil(lim * cy)) + 2  # canvas extension and largest shear offset
    ys = torch.arange(h, dtype=torch.float32, device=dev) - cy
    x = _row_fractional_shift(x, q[:, None] * ys[None, :], o,
                              out_width=w + 2 * e, out_origin=-e, max_offset=e)
    x = _row_resample(x, p, _fma(q, cy, r) + e, o, out_width=w)
    x = x.transpose(1, 2)
    g = a10 / safe_a11
    x = _row_resample(x, a11, _fma(-a11, e, _fma(a10, cy, t1)), o, out_width=h + 2 * e)
    xs = torch.arange(w, dtype=torch.float32, device=dev) - cy
    x = _row_fractional_shift(x, g[:, None] * xs[None, :], o,
                              out_width=h, out_origin=e, max_offset=e)
    return x.transpose(1, 2).contiguous()


def transform_points(
    points_xy: torch.Tensor, forward_matrices: torch.Tensor
) -> torch.Tensor:
    """Apply per-sample (B, 3, 3) forward affines to (B, K, 2) [x, y] points."""
    ones = torch.ones((*points_xy.shape[:-1], 1), dtype=points_xy.dtype,
                      device=points_xy.device)
    ph = torch.cat([points_xy, ones], dim=-1)  # (B, K, 3)
    out = torch.einsum("bij,bkj->bki", forward_matrices.to(points_xy.dtype), ph)
    return out[..., :2]


def _to_views(x: torch.Tensor, v: int) -> torch.Tensor:
    """(B, H, W, V*c) view-blocked channels -> (B*V, H, W, c)."""
    b, h, w, ctot = x.shape
    return x.reshape(b, h, w, v, ctot // v).permute(0, 3, 1, 2, 4).reshape(
        b * v, h, w, ctot // v)


def _from_views(x: torch.Tensor, v: int) -> torch.Tensor:
    """(B*V, H, W, c) -> (B, H, W, V*c)."""
    bv, h, w, c = x.shape
    return x.reshape(bv // v, v, h, w, c).permute(0, 2, 3, 1, 4).reshape(
        bv // v, h, w, v * c)


def _draw_plan(
    generator: torch.Generator, images: torch.Tensor, method: str,
    rotation_range: float, shear_range: float,
) -> tuple[float, float, bool, float]:
    """(rotation_low, rotation_high, quadrants, shear_limit) of one call.
    The separable warp at H >= 96 draws one canvas bucket for the whole
    batch, before any per-row draw (the same on every process of a
    data-parallel step)."""
    buckets = (rotation_buckets(rotation_range, shear_range)
               if method == "separable" and images.shape[1] >= _BUCKET_MIN_HEIGHT
               else None)
    if buckets:
        lo, hi, quad = buckets[draws.scalar_randint(len(buckets), generator,
                                                    generator.device)]
        return lo, hi, quad, _shear_limit(hi, shear_range)
    return 0.0, rotation_range, False, _shear_limit(rotation_range, shear_range)


def _warp(images: torch.Tensor, mats: torch.Tensor, order: int, method: str,
          shear_limit: float) -> torch.Tensor:
    if method == "separable":
        return affine_warp_separable_batch(images, mats, order, shear_limit=shear_limit)
    return affine_warp_batch(images, mats, order)


def augment_views_and_peaks(
    generator: torch.Generator,
    images: torch.Tensor,
    peaks_xy: torch.Tensor,
    peak_vals: torch.Tensor,
    num_views: int = 1,
    sigma: float = 3.0,
    rotation_range: float = 30.0,
    xy_shifts: float = 10.0,
    zoom_range: tuple[float, float] = (1.0, 1.0),
    do_horizontal_flip: bool = True,
    do_vertical_flip: bool = True,
    shear_range: float = 0.0,
    order: int = 1,
    method: str = "separable",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-view augmentation with targets re-rendered at the moved peaks.

    Only the image channels are warped; the targets are sigma-Gaussians
    rendered at the transformed peaks, times ``peak_vals`` (0 for an absent
    keypoint gives a zero map). View v of a multi-camera sample owns image
    channels [v*c, (v+1)*c) and keypoints [v*k, (v+1)*k), and gets its own
    transform (pytorch/Datagenerators.py:141-153); views ride the batch axis
    of one warp.

    Args:
      images: (B, H, W, V*c); peaks_xy: (B, V*k, 2) [x, y]; peak_vals:
        (B, V*k); num_views: V.

    ``method`` names the warp (module docstring); the separable one draws
    a canvas bucket first (:func:`rotation_buckets`).

    Returns:
      (warped images, (B, H, W, V*k) float32 maps, (B, V, 3, 3) matrices).
    """
    _check_method(method)
    b, h, w, _ = images.shape
    v = int(num_views)
    low, high, quadrants, limit = _draw_plan(generator, images, method,
                                             rotation_range, shear_range)
    params = sample_augment_params(
        generator, b * v, rotation_range=high, xy_shifts=xy_shifts,
        zoom_range=zoom_range, do_horizontal_flip=do_horizontal_flip,
        do_vertical_flip=do_vertical_flip, shear_range=shear_range,
        rotation_low=low, quadrants=quadrants)
    mats = make_affine_matrix(params, h, w)  # (B*V, 3, 3)
    warped = _warp(_to_views(images, v), mats, order, method, limit)
    warped = _from_views(warped, v)
    ktot = peaks_xy.shape[1]
    pk = peaks_xy.float().reshape(b * v, ktot // v, 2)
    new_peaks = transform_points(pk, mats).reshape(b, ktot, 2)
    maps = confmaps_from_peaks(new_peaks, (h, w), sigma) * peak_vals[:, None, None, :]
    return warped, maps, mats.reshape(b, v, 3, 3)


def augment_images_and_peaks(
    generator: torch.Generator,
    images: torch.Tensor,
    peaks_xy: torch.Tensor,
    peak_vals: torch.Tensor,
    sigma: float = 3.0,
    rotation_range: float = 30.0,
    xy_shifts: float = 10.0,
    zoom_range: tuple[float, float] = (1.0, 1.0),
    do_horizontal_flip: bool = True,
    do_vertical_flip: bool = True,
    shear_range: float = 0.0,
    order: int = 1,
    method: str = "separable",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-view :func:`augment_views_and_peaks`: (warped images,
    rendered (B, H, W, K) maps)."""
    warped, maps, _ = augment_views_and_peaks(
        generator, images, peaks_xy, peak_vals, num_views=1, sigma=sigma,
        rotation_range=rotation_range, xy_shifts=xy_shifts,
        zoom_range=zoom_range, do_horizontal_flip=do_horizontal_flip,
        do_vertical_flip=do_vertical_flip, shear_range=shear_range,
        order=order, method=method)
    return warped, maps


def augment_pair(
    generator: torch.Generator,
    images: torch.Tensor,
    confmaps: torch.Tensor,
    rotation_range: float = 30.0,
    xy_shifts: float = 10.0,
    zoom_range: tuple[float, float] = (1.0, 1.0),
    do_horizontal_flip: bool = True,
    do_vertical_flip: bool = True,
    shear_range: float = 0.0,
    order: int = 1,
    method: str = "separable",
    num_views: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One transform per sample (per view for ``num_views > 1``) applied to
    the images and the target confmaps together, as one warp of their
    channel concatenation (``SimpleDataGenerator.perform_augmentations``,
    tensorflow/simple_data_generator.py:72-95). Catmull-Rom (the separable
    warp, or order >= 2) rings below zero, so warped targets are clamped at
    0 there."""
    _check_method(method)
    b, h, w, ci = images.shape
    cm = confmaps.shape[-1]
    v = int(num_views)
    low, high, quadrants, limit = _draw_plan(generator, images, method,
                                             rotation_range, shear_range)
    params = sample_augment_params(
        generator, b * v, rotation_range=high, xy_shifts=xy_shifts,
        zoom_range=zoom_range, do_horizontal_flip=do_horizontal_flip,
        do_vertical_flip=do_vertical_flip, shear_range=shear_range,
        rotation_low=low, quadrants=quadrants)
    mats = make_affine_matrix(params, h, w)
    stacked = torch.cat(
        [_to_views(images, v), _to_views(confmaps.to(images.dtype), v)], dim=-1)
    warped = _warp(stacked, mats, order, method, limit)
    warped_imgs = _from_views(warped[..., : ci // v], v)
    warped_maps = _from_views(warped[..., ci // v :], v)
    if method == "separable" or order >= 2:
        warped_maps = warped_maps.clamp_min(0.0)
    return warped_imgs, warped_maps.to(confmaps.dtype)
