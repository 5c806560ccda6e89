"""Multi-view camera geometry for 3D lifting (PyTorch port).

Counterpart of the lifting half of ``pose_estimation_amitai_tpu/ops/
geometry.py``: two-view SVD triangulation (the reference's
``custom_triangulation``, pytorch/Datagenerators.py:322-345), crop-to-sensor
coordinates (pytorch/preprocessor.py:313-317) and the all-pairs multi-view
mean. Plain functions on tensors; leading batch dimensions broadcast, so
the JAX ``vmap`` over frames becomes a batch dimension.
"""

from __future__ import annotations

import torch

from ..constants import SENSOR_HEIGHT

CAMERA_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def triangulate_pair(
    Pa: torch.Tensor, Pb: torch.Tensor,
    points_a: torch.Tensor, points_b: torch.Tensor,
) -> torch.Tensor:
    """Two-view linear (DLT) triangulation via SVD.

    Args:
      Pa, Pb: (3, 4) projection matrices.
      points_a, points_b: (..., 2) pixel coordinates in each view.

    Returns:
      (..., 3) points: the right-singular vector of the smallest singular
      value of the four cross-product rows, de-homogenised. Rows and
      columns are equilibrated first (exact for the null space, better
      conditioned in f32), as in the JAX version.
    """
    A = torch.stack(
        [
            points_a[..., 0:1] * Pa[2] - Pa[0],
            points_a[..., 1:2] * Pa[2] - Pa[1],
            points_b[..., 0:1] * Pb[2] - Pb[0],
            points_b[..., 1:2] * Pb[2] - Pb[1],
        ],
        dim=-2,
    )  # (..., 4, 4)
    A = A / (torch.linalg.norm(A, dim=-1, keepdim=True) + 1e-12)
    col = torch.linalg.norm(A, dim=-2, keepdim=True) + 1e-12  # (..., 1, 4)
    _, _, vh = torch.linalg.svd(A / col)
    X = vh[..., -1, :] / col[..., 0, :]
    return X[..., :3] / X[..., 3:4]


def uncrop_points(
    points_2d: torch.Tensor, cropzone: torch.Tensor
) -> torch.Tensor:
    """Crop-local [x, y] -> full-sensor coords, y flipped.

    Args:
      points_2d: (..., N, 2) crop-local [x, y].
      cropzone: (..., 2) [y_crop, x_crop] per camera.
    """
    x = points_2d[..., 0] + cropzone[..., 1:2]
    y = points_2d[..., 1] + cropzone[..., 0:1]
    return torch.stack([x, (SENSOR_HEIGHT + 1) - y], dim=-1)


def triangulate_multiview(
    Ps: torch.Tensor, points_2d: torch.Tensor
) -> torch.Tensor:
    """Mean of the 6 pairwise triangulations.

    Args:
      Ps: (4, 3, 4) cameras; points_2d: (..., 4, N, 2) full-sensor coords.

    Returns:
      (..., N, 3).
    """
    acc = [
        triangulate_pair(
            Ps[a], Ps[b], points_2d[..., a, :, :], points_2d[..., b, :, :]
        )
        for a, b in CAMERA_PAIRS
    ]
    return torch.stack(acc).mean(dim=0)
