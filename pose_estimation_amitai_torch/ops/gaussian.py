"""Gaussian confidence-map rendering (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/ops/gaussian.py`` (reference:
tensorflow/simple_data_generator.py:119-136, ``get_gaussian`` /
``ensure_sigma``): one broadcast exp over the whole (N, C, H, W) stack on
the peaks' device; elementwise work, so no kernel of its own.
"""

from __future__ import annotations

import torch


def gaussian_confmap(
    peaks_xy: torch.Tensor,
    grid_size: tuple[int, int] = (192, 192),
    sigma: float = 3.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Gaussians ``exp(-d^2 / (2 sigma^2))`` centred at ``peaks_xy``.

    Args:
      peaks_xy: (..., 2) [x, y] peak coordinates, e.g. (N, C, 2).
      grid_size: (H, W) of the integer pixel grid.

    Returns:
      (..., H, W) maps: (N, C, 2) -> (N, C, H, W).
    """
    h, w = grid_size
    xs = torch.arange(w, dtype=dtype, device=peaks_xy.device)
    ys = torch.arange(h, dtype=dtype, device=peaks_xy.device)
    dx2 = torch.square(xs - peaks_xy[..., 0:1])  # (..., W)
    dy2 = torch.square(ys - peaks_xy[..., 1:2])  # (..., H)
    d2 = dy2[..., :, None] + dx2[..., None, :]  # (..., H, W)
    return torch.exp(-d2 / (2.0 * sigma**2)).to(dtype)


def confmaps_from_peaks(
    peaks_xy: torch.Tensor,
    grid_size: tuple[int, int] = (192, 192),
    sigma: float = 3.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(N, C, 2) peaks -> (N, H, W, C) NHWC confidence maps."""
    return gaussian_confmap(peaks_xy, grid_size, sigma, dtype).permute(0, 2, 3, 1)


def ensure_sigma(confmaps: torch.Tensor, sigma: float = 3.0) -> torch.Tensor:
    """Re-render (N, H, W, C) confmaps as fixed-sigma Gaussians at their
    argmax peaks. An all-zero channel (a missing keypoint) stays zero rather
    than becoming a corner Gaussian at its (0, 0) argmax."""
    from .peaks import find_peaks

    n, h, w, c = confmaps.shape
    out = confmaps_from_peaks(find_peaks(confmaps), (h, w), sigma, confmaps.dtype)
    alive = confmaps.amax(dim=(1, 2), keepdim=True) > 0  # (N, 1, 1, C)
    return torch.where(alive, out, torch.zeros_like(out))
