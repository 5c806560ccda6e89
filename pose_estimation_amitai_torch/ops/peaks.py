"""Keypoint decoding from confidence maps (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/ops/peaks.py``: the serving
decodes, hard argmax (the reference's ``tf_find_peaks``,
tensorflow/preprocessor.py:657-689), the log-parabola sub-pixel refinement
and the soft-argmax (pytorch/utils.py:47-83); and the training ones, the
marginal soft-argmax of the pointwise loss (tensorflow/Network.py:519-547)
and the validation L2. Plain functions on tensors; they run on the
tensors' device.

Layout: NHWC maps (N, H, W, C); peaks (N, 3, C) [x, y, val].
"""

from __future__ import annotations

import torch


def _argmax2d(
    confmaps: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rows, cols, vals) of the per-channel spatial argmax, first
    occurrence on ties.

    The JAX form, kept as written: a max for the value, then the least
    linear index where the map equals it. A channel holding NaN has val NaN
    and no pixel equal to it, so its index clamps to the last pixel,
    h*w - 1 (``torch.argmax`` would point at the NaN instead)."""
    n, h, w, c = confmaps.shape
    vals = confmaps.amax(dim=(1, 2))  # (N, C)
    lin = torch.arange(h * w, dtype=torch.int32, device=confmaps.device)
    masked = torch.where(
        confmaps == vals[:, None, None, :], lin.view(1, h, w, 1), h * w
    )
    idx = masked.amin(dim=(1, 2)).clamp_max(h * w - 1)  # (N, C)
    return idx // w, idx % w, vals


def find_peaks_with_vals(confmaps: torch.Tensor) -> torch.Tensor:
    """Per-channel argmax decode: (N, H, W, C) -> (N, 3, C) [x, y, val]
    float32."""
    rows, cols, vals = _argmax2d(confmaps)
    return torch.stack([cols.float(), rows.float(), vals.float()], dim=1)


def find_peaks(confmaps: torch.Tensor) -> torch.Tensor:
    """Argmax decode returning (N, C, 2) [x, y] coordinates."""
    return find_peaks_with_vals(confmaps).transpose(1, 2)[..., :2]


def find_peaks_refined(
    confmaps: torch.Tensor, eps: float = 1e-8
) -> torch.Tensor:
    """Sub-pixel argmax decode: three-point parabola fit of the log map
    around the integer peak, per axis, offsets clamped to +-0.5 px (exact
    for the sigma-Gaussian targets). Falls back to the integer peak at the
    border and where a neighbour or the peak is <= eps.

    Returns (N, 3, C) [x, y, val], the :func:`find_peaks_with_vals`
    contract with sub-pixel x, y."""
    n, h, w, c = confmaps.shape
    maps = confmaps.float()
    flat = maps.reshape(n, h * w, c)
    rows, cols, vals = _argmax2d(maps)

    def neighbor(dy: int, dx: int) -> torch.Tensor:
        r = (rows + dy).clamp(0, h - 1)
        cc = (cols + dx).clamp(0, w - 1)
        return torch.gather(flat, 1, (r * w + cc).long()[:, None, :])[:, 0, :]

    def log_floor(v: torch.Tensor) -> torch.Tensor:
        return torch.log(torch.maximum(v, torch.tensor(eps, device=v.device)))

    def axis_offset(f_minus, f_plus, interior):
        ok = interior & (f_minus > eps) & (f_plus > eps) & (vals > eps)
        lm, lp, l0 = log_floor(f_minus), log_floor(f_plus), log_floor(vals)
        denom = 2.0 * l0 - lm - lp
        big = denom.abs() > eps
        safe = torch.where(big, denom, torch.ones_like(denom))
        off = torch.where(big, 0.5 * (lp - lm) / safe, torch.zeros_like(denom))
        return torch.where(ok, off.clamp(-0.5, 0.5), torch.zeros_like(off))

    dx = axis_offset(neighbor(0, -1), neighbor(0, 1), (cols > 0) & (cols < w - 1))
    dy = axis_offset(neighbor(-1, 0), neighbor(1, 0), (rows > 0) & (rows < h - 1))
    return torch.stack([cols.float() + dx, rows.float() + dy, vals], dim=1)


def find_peaks_soft_argmax(confmaps: torch.Tensor) -> torch.Tensor:
    """Soft-argmax decode: the normalised-meshgrid expectation, rescaled to
    pixels and clamped to the image (pytorch/utils.py:47-83), NHWC.
    An all-zero channel decodes to a finite coordinate (sum floored at
    1e-9). Returns (N, C, 2) [x, y]."""
    n, h, w, c = confmaps.shape
    dev = confmaps.device
    y_grid = torch.linspace(0.0, 1.0, h, device=dev).view(1, h, 1, 1)
    x_grid = torch.linspace(0.0, 1.0, w, device=dev).view(1, 1, w, 1)
    total = confmaps.sum(dim=(1, 2))
    total = torch.where(total.abs() < 1e-9, torch.full_like(total, 1e-9), total)
    cx = (x_grid * confmaps).sum(dim=(1, 2)) / total
    cy = (y_grid * confmaps).sum(dim=(1, 2)) / total
    cx = (cx * (w - 1)).clamp(0.0, w - 1)
    cy = (cy * (h - 1)).clamp(0.0, h - 1)
    return torch.stack([cx, cy], dim=-1)


def marginal_soft_argmax(heatmaps: torch.Tensor) -> torch.Tensor:
    """Marginal-expectation decode of the TF ``PointWiseLoss``
    (tensorflow/Network.py:519-534): E[x], E[y] over the 1-indexed column
    and row marginals, minus 1, with the image size taken from the shape
    (the reference hard-codes 192). An all-zero channel's sum is floored at
    1e-9, so it decodes to a finite point. (N, H, W, C) -> (N, C, 2) [x, y]."""
    n, h, w, c = heatmaps.shape
    dev, dt = heatmaps.device, heatmaps.dtype
    lin_y = torch.arange(1, h + 1, dtype=dt, device=dev).reshape(1, h, 1)
    lin_x = torch.arange(1, w + 1, dtype=dt, device=dev).reshape(1, w, 1)
    total = heatmaps.sum(dim=(1, 2))  # (N, C)
    total = torch.where(total.abs() < 1e-9, torch.full_like(total, 1e-9), total)
    h_y = (lin_y * heatmaps.sum(dim=2)).sum(dim=1) / total
    h_x = (lin_x * heatmaps.sum(dim=1)).sum(dim=1) / total
    return torch.stack([h_x - 1.0, h_y - 1.0], dim=-1)


def pointwise_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """MSE between the marginal soft-argmax keypoints of two map stacks
    (``PointWiseLoss.pointwize_loss``, tensorflow/Network.py:536-547)."""
    return torch.square(marginal_soft_argmax(y_true)
                        - marginal_soft_argmax(y_pred)).mean()


def l2_distances(
    pred_confmaps: torch.Tensor,
    true_confmaps: torch.Tensor,
    decode: str = "argmax",
) -> torch.Tensor:
    """(N, C) pixel distances between the decoded peaks of predicted and true
    maps, the reference's validation metric (pytorch/train_pytorch.py:199-213).
    ``decode="argmax"`` is the reference's; ``"refined"`` decodes both with
    :func:`find_peaks_refined`."""
    if decode == "refined":
        def dec(maps: torch.Tensor) -> torch.Tensor:
            return find_peaks_refined(maps)[:, :2, :].transpose(1, 2)
    else:
        dec = find_peaks
    return torch.linalg.norm(dec(pred_confmaps) - dec(true_confmaps), dim=-1)
