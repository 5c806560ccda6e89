"""On-device affine augmentation (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/ops/affine.py`` (reference:
pytorch/Augmentor.py:31-43, 96-103; tensorflow/simple_data_generator.py:72-95):
the flip -> scale -> shift -> rotate chain is composed into one 3x3 matrix
per sample, and the images are inverse-warped by a gather of their 2 x 2
(bilinear, order <= 1) or 4 x 4 (Catmull-Rom, a = -0.5, order >= 2) source
taps; reads outside the image are 0 (cv2 BORDER_CONSTANT 0).

This is the gather form, which JAX calls ``method="exact"``. JAX's train
step takes ``method="separable"`` by default: a two-pass shear/resample warp
with canvas buckets, built for the TPU's gather cost; it is not ported
(ROADMAP Queue A item 6 records the deviation and its size). The cubic
weights are written out here because ``grid_sample(mode="bicubic")`` uses
a = -0.75.

Random draws come from an explicit ``torch.Generator`` on the images'
device: the train step derives one from (seed, step, microbatch).
"""

from __future__ import annotations

from typing import NamedTuple

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


def _check_method(method: str) -> None:
    if method == "separable":
        raise NotImplementedError(
            "method='separable' (the TPU's two-pass warp) is not ported; the "
            "port warps by gather, method='exact' (ROADMAP Queue A item 6)")
    if method != "exact":
        raise ValueError(f"method={method!r}; the port has 'exact' only")


def sample_augment_params(
    generator: torch.Generator,
    batch: int,
    rotation_range: float = 30.0,
    xy_shifts: float = 10.0,
    zoom_range: tuple[float, float] = (1.0, 1.0),
    do_horizontal_flip: bool = True,
    do_vertical_flip: bool = True,
    shear_range: float = 0.0,
) -> AugmentParams:
    """Draw per-sample parameters on the generator's device: angle uniform
    in +-rotation_range, scale uniform in zoom_range, shifts uniform in
    +-xy_shifts, Bernoulli(0.5) flips gated by the switches, keras shear
    uniform in +-shear_range (tensorflow/simple_data_generator.py:72-95,
    pytorch/Datagenerators.py:169-185, tensorflow/Augmentor.py:44)."""

    def uniform(lo: float, hi: float) -> torch.Tensor:
        u = draws.rand((batch,), generator, generator.device)
        return lo + (hi - lo) * u

    def coin() -> torch.Tensor:
        return draws.rand((batch,), generator, generator.device) < 0.5

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


def _cubic_weights(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Catmull-Rom (Keys a = -0.5) weights of the taps at (-1, 0, 1, 2)."""
    a = -0.5
    t2 = t * t
    t3 = t2 * t
    w0 = a * (t3 - 2.0 * t2 + t)
    w1 = (a + 2.0) * t3 - (a + 3.0) * t2 + 1.0
    w2 = -(a + 2.0) * t3 + (2.0 * a + 3.0) * t2 - a * t
    w3 = a * (t2 - t3)
    return w0, w1, w2, w3


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
    inv = torch.linalg.inv(forward_matrices.float())[:, :, :, None, None]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    src_x = inv[:, 0, 0] * xs + inv[:, 0, 1] * ys + inv[:, 0, 2]  # (B, H, W)
    src_y = inv[:, 1, 0] * xs + inv[:, 1, 1] * ys + inv[:, 1, 2]
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    tx = src_x - x0
    ty = src_y - y0
    if order <= 1:
        taps = (0, 1)
        wx, wy = (1.0 - tx, tx), (1.0 - ty, ty)
    else:
        taps = (-1, 0, 1, 2)
        wx, wy = _cubic_weights(tx), _cubic_weights(ty)

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
    method: str = "exact",
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

    Returns:
      (warped images, (B, H, W, V*k) float32 maps, (B, V, 3, 3) matrices).
    """
    _check_method(method)
    b, h, w, _ = images.shape
    v = int(num_views)
    params = sample_augment_params(
        generator, b * v, rotation_range=rotation_range, xy_shifts=xy_shifts,
        zoom_range=zoom_range, do_horizontal_flip=do_horizontal_flip,
        do_vertical_flip=do_vertical_flip, shear_range=shear_range)
    mats = make_affine_matrix(params, h, w)  # (B*V, 3, 3)
    warped = affine_warp_batch(_to_views(images, v), mats, order)
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
    method: str = "exact",
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
    method: str = "exact",
    num_views: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One transform per sample (per view for ``num_views > 1``) applied to
    the images and the target confmaps together, as one warp of their
    channel concatenation (``SimpleDataGenerator.perform_augmentations``,
    tensorflow/simple_data_generator.py:72-95). Catmull-Rom (order >= 2)
    rings below zero, so warped targets are clamped at 0 there."""
    _check_method(method)
    b, h, w, ci = images.shape
    cm = confmaps.shape[-1]
    v = int(num_views)
    params = sample_augment_params(
        generator, b * v, rotation_range=rotation_range, xy_shifts=xy_shifts,
        zoom_range=zoom_range, do_horizontal_flip=do_horizontal_flip,
        do_vertical_flip=do_vertical_flip, shear_range=shear_range)
    mats = make_affine_matrix(params, h, w)
    stacked = torch.cat(
        [_to_views(images, v), _to_views(confmaps.to(images.dtype), v)], dim=-1)
    warped = affine_warp_batch(stacked, mats, order)
    warped_imgs = _from_views(warped[..., : ci // v], v)
    warped_maps = _from_views(warped[..., ci // v :], v)
    if order >= 2:
        warped_maps = warped_maps.clamp_min(0.0)
    return warped_imgs, warped_maps.to(confmaps.dtype)
