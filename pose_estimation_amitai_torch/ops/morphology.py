"""Binary and grey morphology as max/min over shifted padded slices
(PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/ops/morphology.py`` (reference:
pytorch/preprocessor.py:390-393 ``binary_closing`` + ``binary_dilation``;
tensorflow/preprocessor.py:601-619, the disk dilate/erode of the body
masks). Every function takes any leading batch dimensions and runs on the
tensor's device. Structuring elements follow scipy's defaults: ``cross(1)``
is ``generate_binary_structure(2, 1)``, ``disk(r)`` skimage's disk.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import draws


def cross(radius: int = 1) -> np.ndarray:
    """Cross/diamond structuring element: |dx| + |dy| <= radius."""
    ys, xs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    return (np.abs(ys) + np.abs(xs) <= radius).astype(np.bool_)


def disk(radius: int) -> np.ndarray:
    """Disk structuring element: dx^2 + dy^2 <= r^2 (skimage.morphology.disk)."""
    ys, xs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    return (ys**2 + xs**2 <= radius**2).astype(np.bool_)


def _masked_window_reduce(
    mask: torch.Tensor, structure: np.ndarray, is_dilation: bool
) -> torch.Tensor:
    """One dilation (max) or erosion (min) step over the trailing two dims,
    as a reduction over the footprint's shifted slices of the zero-padded
    mask. Outside the image counts as background (scipy's border_value 0),
    so erosion eats the border."""
    sh, sw = structure.shape
    ph, pw = sh // 2, sw // 2
    *lead, h, w = mask.shape
    m = mask.float().reshape(-1, h, w)
    padded = F.pad(m, (pw, pw, ph, ph), value=0.0)
    op = torch.maximum if is_dilation else torch.minimum
    out = torch.full_like(m, 0.0 if is_dilation else 1.0)
    for dy in range(sh):
        for dx in range(sw):
            if structure[dy, dx]:
                out = op(out, padded[:, dy : dy + h, dx : dx + w])
    return (out > 0.5).reshape(*lead, h, w)


def binary_dilation(
    mask: torch.Tensor, structure: np.ndarray | None = None, iterations: int = 1
) -> torch.Tensor:
    """scipy.ndimage.binary_dilation equivalent (default cross structure)."""
    structure = cross(1) if structure is None else structure
    out = mask
    for _ in range(max(int(iterations), 0)):
        out = _masked_window_reduce(out, structure, is_dilation=True)
    return out


def binary_erosion(
    mask: torch.Tensor, structure: np.ndarray | None = None, iterations: int = 1
) -> torch.Tensor:
    """scipy.ndimage.binary_erosion equivalent (default cross structure)."""
    structure = cross(1) if structure is None else structure
    out = mask
    for _ in range(max(int(iterations), 0)):
        out = _masked_window_reduce(out, structure, is_dilation=False)
    return out


def binary_closing(
    mask: torch.Tensor, structure: np.ndarray | None = None
) -> torch.Tensor:
    """scipy.ndimage.binary_closing equivalent: dilation then erosion."""
    return binary_erosion(binary_dilation(mask, structure), structure)


def adjust_mask(mask: torch.Tensor, mask_dilation: int = 1) -> torch.Tensor:
    """Closing, then ``mask_dilation`` cross dilations
    (``Preprocessor.adjust_mask``, pytorch/preprocessor.py:390-393)."""
    return binary_dilation(binary_closing(mask), iterations=mask_dilation)


def dilate_disk(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Disk dilation (skimage ``dilation(mask, disk(r))``)."""
    return binary_dilation(mask, disk(radius), iterations=1)


def erode_disk(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Disk erosion (skimage ``erosion(mask, disk(r))``)."""
    return binary_erosion(mask, disk(radius), iterations=1)


def grey_dilate_cross(x: torch.Tensor) -> torch.Tensor:
    """One grey dilation with the 3x3 cross over (..., H, W, M): the max of
    each pixel and its 4 neighbours, zero border. On {0, 1} masks it is one
    ``binary_dilation`` iteration."""
    h, w = x.shape[-3], x.shape[-2]
    p = F.pad(x, (0, 0, 1, 1, 1, 1))

    def sl(dy: int, dx: int) -> torch.Tensor:
        return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w, :]

    out = sl(0, 0)
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        out = torch.maximum(out, sl(dy, dx))
    return out


def random_mask_redilation(
    generator: torch.Generator,
    images: torch.Tensor,
    max_dilation: int,
    num_views: int = 1,
    num_time_channels: int = 3,
    masks_per_view: int | None = None,
) -> torch.Tensor:
    """Re-dilate the wing-mask channels of (B, H, W, C) samples at random.

    The ``wings_masks_dilation`` augmentation
    (tensorflow/simple_data_generator.py:84-87, 99-117): with probability
    0.5 a sample's masks are dilated ``k ~ randint(0, max_dilation)`` times
    (exclusive bound, so 1 is a no-op, as in the reference), both drawn
    from ``generator`` (on the images' device). Mask channels: the last
    ``masks_per_view`` of each of ``num_views`` channel blocks (the CHANNEL
    layout's view count, ``models.layout_views``); ``None`` infers 1 for
    per-wing blocks (T + 1 channels) and 2 for all-points ones (T + 2); 0
    leaves the images as they are. All ``max_dilation - 1`` steps run and
    each sample keeps its k-th iterate."""
    b, h, w, c = images.shape
    v = int(num_views)
    cpv = c // v
    if masks_per_view is None:
        masks_per_view = max(0, min(cpv - int(num_time_channels), 2))
    else:
        masks_per_view = min(int(masks_per_view), cpv)
    if masks_per_view == 0:
        return images
    mask_inds = torch.tensor(
        [cpv * (i + 1) - 1 - m for i in range(v) for m in range(masks_per_view)],
        device=images.device,
    )
    steps = max(int(max_dilation), 1)
    apply = draws.rand((b,), generator, images.device) < 0.5
    k = draws.randint(steps, (b,), generator, images.device)
    k = torch.where(apply, k, torch.zeros_like(k))

    masks = images.index_select(-1, mask_inds)
    out = acc = masks
    for step in range(1, steps):
        acc = grey_dilate_cross(acc)
        out = torch.where((k >= step)[:, None, None, None], acc, out)
    return images.index_copy(-1, mask_inds, out)


def body_masks(
    time_channels: torch.Tensor, threshold: float = 0.7, radius: int = 6
) -> torch.Tensor:
    """Body segmentation masks (``Preprocessor.get_body_masks``,
    tensorflow/preprocessor.py:601-619): the mean of the (..., H, W, T)
    time channels ``>= threshold``, then disk(``radius``) dilation and disk
    erosion (a closing). Returns (..., H, W) bool."""
    av = time_channels.float().mean(dim=-1)
    return erode_disk(dilate_disk(av >= threshold, radius), radius)
