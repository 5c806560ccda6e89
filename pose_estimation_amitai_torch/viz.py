"""Visualization artifacts: prediction overlays, confmap grids, loss curves
(PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/viz.py`` (reference:
tensorflow/viz.py:1-155 ``show_pred``/``show_confmap_grid``/
``plot_history``; the inline viz in pytorch/train_pytorch.py:222-251): the
same PNGs under the same names. Inputs are numpy arrays. ``matplotlib`` is
imported inside each function, on the 'agg' backend, so the module imports
where it is not installed; :func:`available` says whether it is.
"""

from __future__ import annotations

import importlib.util

import numpy as np


def available() -> bool:
    """True where matplotlib can be imported."""
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    return plt


def show_pred(
    image: np.ndarray,
    pred_points: np.ndarray,
    gt_points: np.ndarray | None = None,
    save_path: str | None = None,
) -> None:
    """Overlay decoded keypoints on the focal time channel (+ mask).

    Twin of pytorch/train_pytorch.py:222-251 (``save_validation_image``):
    >20 output channels means a 4-camera model -> 2x2 panel per camera.
    """
    plt = _plt()
    num_points = pred_points.shape[0]
    if num_points > 20:
        pts_per_cam = np.array_split(pred_points, 4)
        gt_per_cam = (
            np.array_split(gt_points, 4) if gt_points is not None
            else [None] * 4
        )
        images = np.array_split(image, 4, axis=-1)
        fig, axs = plt.subplots(2, 2, figsize=(10, 10))
        axs = axs.ravel()
        for i, (img, pts, gt) in enumerate(
            zip(images, pts_per_cam, gt_per_cam)
        ):
            axs[i].imshow(img[..., 1] + 0.5 * img[..., -1])
            axs[i].scatter(pts[:, 0], pts[:, 1], color="red", s=10, marker="o")
            if gt is not None:
                axs[i].scatter(
                    gt[:, 0], gt[:, 1], color="lime", s=10, marker="x"
                )
            axs[i].axis("off")
    else:
        plt.figure()
        plt.imshow(image[..., 1] + 0.5 * image[..., -1])
        plt.scatter(
            pred_points[:, 0], pred_points[:, 1], color="red", s=10, marker="o"
        )
        if gt_points is not None:
            plt.scatter(
                gt_points[:, 0], gt_points[:, 1], color="lime", s=10, marker="x"
            )
    if save_path:
        plt.savefig(save_path)
    plt.close("all")


def show_confmap_grid(
    confmaps: np.ndarray, save_path: str | None = None, cols: int = 5
) -> None:
    """Montage grid of per-channel confidence maps
    (twin of tensorflow/viz.py:79-133)."""
    plt = _plt()
    c = confmaps.shape[-1]
    rows = int(np.ceil(c / cols))
    fig, axs = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.2 * rows))
    axs = np.atleast_1d(axs).ravel()
    for i in range(len(axs)):
        axs[i].axis("off")
        if i < c:
            axs[i].imshow(confmaps[..., i])
            axs[i].set_title(str(i), fontsize=7)
    if save_path:
        plt.savefig(save_path)
    plt.close(fig)


def plot_history(
    train_losses: list[float],
    val_losses: list[float],
    save_path: str,
    start_epoch: int = 0,
) -> None:
    """Loss curves (twin of tensorflow/viz.py:136-155,
    pytorch/train_pytorch.py:333-345)."""
    plt = _plt()
    best = float(np.min(val_losses)) if val_losses else float("nan")
    plt.figure(figsize=(10, 5))
    plt.title(f"Training and Validation Loss (Best Validation Loss: {best:.7f})")
    xs = np.arange(start_epoch, len(train_losses))
    plt.plot(xs, train_losses[start_epoch:], label="Train")
    plt.plot(xs, val_losses[start_epoch:], label="Val")
    plt.xlabel("Epochs")
    plt.ylabel("Loss")
    plt.legend()
    plt.savefig(save_path)
    plt.close()


def l2_histogram(l2: np.ndarray, epoch: int, save_path: str, n_bins: int = 40) -> None:
    """Overall L2 histogram (pytorch/train_pytorch.py:285-299)."""
    plt = _plt()
    plt.figure(figsize=(10, 6))
    plt.hist(l2, bins=n_bins, edgecolor="black")
    plt.xlabel("l2 distance")
    plt.ylabel("Frequency")
    plt.title(f"Histogram of l2 distances epoch {epoch + 1}")
    plt.savefig(save_path)
    plt.clf()
    plt.close()


def l2_histogram_per_point(
    l2_per_point: np.ndarray, epoch: int, save_path: str, n_bins: int = 20
) -> None:
    """Per-keypoint L2 histograms (pytorch/train_pytorch.py:301-325,
    tensorflow/CallBacks.py:71-102: 4-camera split when >20 joints)."""
    plt = _plt()
    if l2_per_point.shape[0] > 20:
        cams = np.array_split(l2_per_point, 4)
        l2_per_point = np.concatenate(cams, axis=1)
    num_points = l2_per_point.shape[0]
    fig, axs = plt.subplots(num_points, 1, figsize=(12, 4 * num_points))
    axs = np.atleast_1d(axs)
    for i in range(num_points):
        axs[i].hist(l2_per_point[i], bins=n_bins, edgecolor="black")
        axs[i].set_title(
            f"Histogram for Point {i + 1} - Mean: {np.mean(l2_per_point[i]):.2f}, "
            f"Std: {np.std(l2_per_point[i]):.2f}",
            fontsize=12,
        )
        axs[i].set_xlabel("L2 distance in pixels", fontsize=10)
        axs[i].set_ylabel("Frequency", fontsize=10)
    plt.tight_layout(pad=3.0)
    plt.savefig(save_path)
    plt.close(fig)


def show_reconstruction(
    holed: np.ndarray, recon: np.ndarray, clean: np.ndarray, save_path: str
) -> None:
    """Self-supervision before/after panel (the reference saves one per
    epoch, pytorch/self supervision/train_self_supervision.py:226-247): the
    holed input, the reconstruction and the target, (H, W, C) each, their
    channel 1 in gray."""
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, img, title in zip(axes, (holed, recon, clean),
                              ("input (holes)", "reconstruction", "target")):
        ax.imshow(img[..., 1], cmap="gray")
        ax.set_title(title)
        ax.axis("off")
    fig.savefig(save_path, dpi=80)
    plt.close(fig)
