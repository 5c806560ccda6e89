"""Multi-view camera geometry (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/ops/geometry.py``:

* 3D lifting: two-view SVD triangulation (the reference's
  ``custom_triangulation``, pytorch/Datagenerators.py:322-345),
  reprojection, crop-to-sensor coordinates (pytorch/preprocessor.py:313-317),
  the all-pairs multi-view mean and the pairwise reprojection-error score
  of the left/right consistency checker (pytorch/preprocessor.py:305-346);
* the cameras of the disentangled models: DLT estimation from 3D<->2D
  correspondences (tensorflow/Custom_data_generator.py:224-247), the RQ
  decomposition and P -> (K, R, t) (pytorch/Datagenerators.py:404-512), the
  crop-adjusted matrices (:382-402) and an image warp folded into them;
* the FTL projections of the disentangled model (pytorch/CNNs.py:329-352).

Plain functions on tensors; leading batch dimensions broadcast, so the JAX
``vmap`` over frames or cameras becomes a batch dimension. The camera
functions compute in float32, as JAX does on its default precision.
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


def reproject(P: torch.Tensor, points_3d: torch.Tensor) -> torch.Tensor:
    """Project (..., N, 3) world points through a (3, 4) camera: (..., N, 2)."""
    ones = torch.ones((*points_3d.shape[:-1], 1), dtype=points_3d.dtype,
                      device=points_3d.device)
    proj = torch.cat([points_3d, ones], dim=-1) @ P.T  # (..., N, 3)
    return proj[..., :2] / proj[..., 2:3]


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


def reprojection_error_score(
    points_2d: torch.Tensor, cropzone: torch.Tensor, camera_matrices: torch.Tensor
) -> torch.Tensor:
    """Mean pairwise triangulation-reprojection error over the 6 camera
    pairs, in pixels (``get_reprojection_error``,
    pytorch/preprocessor.py:305-346).

    Args:
      points_2d: (..., 4, N, 2) crop-local peaks per camera.
      cropzone: (..., 4, 2) [y, x] crop offsets.
      camera_matrices: (4, 3, 4) full-sensor DLT matrices.

    Returns:
      (...) scores.
    """
    full = uncrop_points(points_2d, cropzone)  # (..., 4, N, 2)
    errs = []
    for a, b in CAMERA_PAIRS:
        Pa, Pb = camera_matrices[a], camera_matrices[b]
        fa, fb = full[..., a, :, :], full[..., b, :, :]
        pts3d = triangulate_pair(Pa, Pb, fa, fb)
        ea = torch.linalg.norm(fa - reproject(Pa, pts3d), dim=-1).mean(dim=-1)
        eb = torch.linalg.norm(fb - reproject(Pb, pts3d), dim=-1).mean(dim=-1)
        errs.append((ea + eb) / 2.0)
    return torch.stack(errs).mean(dim=0)


# ---------------------------------------------------------------------------
# Cameras of the disentangled models
# ---------------------------------------------------------------------------
def estimate_projection_dlt(
    points_3d: torch.Tensor, points_2d: torch.Tensor
) -> torch.Tensor:
    """A (3, 4) projection matrix from >= 6 (N, 3) <-> (N, 2)
    correspondences: the SVD null vector of the DLT system, scaled so
    P[2, 3] == 1 (which also fixes the null vector's sign). It computes in
    the points' dtype."""
    X, Y, Z = points_3d[:, 0], points_3d[:, 1], points_3d[:, 2]
    x, y = points_2d[:, 0], points_2d[:, 1]
    zeros, ones = torch.zeros_like(X), torch.ones_like(X)
    row_x = torch.stack([-X, -Y, -Z, -ones, zeros, zeros, zeros, zeros,
                         x * X, x * Y, x * Z, x], dim=1)
    row_y = torch.stack([zeros, zeros, zeros, zeros, -X, -Y, -Z, -ones,
                         y * X, y * Y, y * Z, y], dim=1)
    _, _, vh = torch.linalg.svd(torch.cat([row_x, row_y]))
    P = vh[-1].reshape(3, 4)
    return P / P[2, 3]


def _rotation(c: torch.Tensor, s: torch.Tensor, rows) -> torch.Tensor:
    """A (..., 3, 3) matrix whose entries are 0, 1, c, s, -c or -s as
    ``rows`` names them."""
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    pick = {"1": one, "0": zero, "c": c, "s": s, "-c": -c, "-s": -s}
    return torch.stack([torch.stack([pick[e] for e in row], dim=-1) for row in rows],
                       dim=-2)


def rq3(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """RQ decomposition of (..., 3, 3) matrices by three Givens rotations
    (the reference's ``RQ3``, pytorch/Datagenerators.py:427-468): (R upper
    triangular with a positive diagonal, Q orthonormal), A = R Q. The 1e-10
    the reference adds to three pivots is kept; in float32 it vanishes
    beside entries of order 1, as in JAX."""
    eps = 1e-10
    A = A.clone()
    A[..., 2, 2] += eps
    d = torch.sqrt(A[..., 2, 2] ** 2 + A[..., 2, 1] ** 2)
    Qx = _rotation(-A[..., 2, 2] / d, A[..., 2, 1] / d,
                   (("1", "0", "0"), ("0", "c", "-s"), ("0", "s", "c")))
    R = A @ Qx
    R[..., 2, 2] += eps
    d = torch.sqrt(R[..., 2, 2] ** 2 + R[..., 2, 0] ** 2)
    Qy = _rotation(R[..., 2, 2] / d, R[..., 2, 0] / d,
                   (("c", "0", "s"), ("0", "1", "0"), ("-s", "0", "c")))
    R = R @ Qy
    R[..., 1, 1] += eps
    d = torch.sqrt(R[..., 1, 1] ** 2 + R[..., 1, 0] ** 2)
    Qz = _rotation(-R[..., 1, 1] / d, R[..., 1, 0] / d,
                   (("c", "-s", "0"), ("s", "c", "0"), ("0", "0", "1")))
    R = R @ Qz
    Q = Qz.mT @ Qy.mT @ Qx.mT
    sign = torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return R * sign[..., None, :], Q * sign[..., :, None]


def decompose_camera(
    P: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., 3, 4) cameras -> (K (..., 3, 3), R (..., 3, 3), t (..., 3, 1)):
    the camera centre from the 3x3 minors, K and R by :func:`rq3`, t = -R C
    (``DecomposeCamera``, pytorch/Datagenerators.py:404-413, 471-512)."""
    M = P[..., :3]
    p1, p2, p3, p4 = (P[..., i] for i in range(4))

    def det(*cols):
        return torch.linalg.det(torch.stack(cols, dim=-1))

    C = torch.stack([det(p2, p3, p4), -det(p1, p3, p4), det(p1, p2, p4)], dim=-1)
    C = C / (-torch.linalg.det(M))[..., None]
    K, R = rq3(M)
    t = -(R @ C[..., None])
    return K, R, t


def crop_adjusted_matrices(
    Ks: torch.Tensor, Rs: torch.Tensor, ts: torch.Tensor, cropzone: torch.Tensor,
    crop_size: int = 192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-crop cameras (``get_cropped_camera_matrices``,
    pytorch/Datagenerators.py:382-402): each K normalised by K[2, 2], its
    principal point shifted by dx = x_crop, dy = SENSOR_HEIGHT + 1 - y_crop -
    crop_size; P' = K' [R | t] and its pseudo-inverse, each of unit
    Frobenius norm. The frame is ``(x_local, crop_size - y_local)``.

    Args:
      Ks, Rs: (..., 3, 3); ts: (..., 3, 1); cropzone: (..., 2) [y, x].

    Returns:
      (P (..., 3, 4), P_inv (..., 4, 3)), float32; the pseudo-inverse is
      taken in float64.
    """
    K = Ks.float() / Ks[..., 2:3, 2:3].float()
    cz = cropzone.float()
    lead = torch.broadcast_shapes(K.shape[:-2], cz.shape[:-1])
    shift = torch.zeros(*lead, 3, 3, device=K.device)
    shift[..., 0, 2] = cz[..., 1]
    shift[..., 1, 2] = SENSOR_HEIGHT + 1 - cz[..., 0] - crop_size
    P = (K - shift) @ torch.cat([Rs.float(), ts.float()], dim=-1)
    P = P / torch.linalg.norm(P, dim=(-2, -1), keepdim=True)
    # a crop-adjusted camera's condition number is in the thousands, and a
    # float32 pseudo-inverse (JAX's) is then off by about 1e-5 at unit norm:
    # this one is taken in float64 and rounded once
    P_inv = torch.linalg.pinv(P.double())
    P_inv = P_inv / torch.linalg.norm(P_inv, dim=(-2, -1), keepdim=True)
    return P, P_inv.float()


def compose_affine_into_cameras(
    mats: torch.Tensor, P: torch.Tensor, P_inv: torch.Tensor, crop_size: int = 192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold image warps into cameras: P' = (F M F) P and P_inv' = P_inv
    (F M F)^-1, each renormalised to unit Frobenius norm.

    ``mats`` (..., 3, 3) are forward affines on (x, row) pixel coordinates
    (the augmentation's); the crop-adjusted cameras project to (x, v) with
    row = crop_size - v, so the warp is conjugated by the self-inverse flip
    F = [[1, 0, 0], [0, -1, crop_size], [0, 0, 1]]. For a full-row-rank P,
    pinv(A P) = pinv(P) A^-1, so no SVD is needed. Leading axes broadcast,
    e.g. (B, V, ...)."""
    flip = torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, float(crop_size)],
                         [0.0, 0.0, 1.0]], device=mats.device)
    mats = flip @ mats.float() @ flip
    new_P = mats @ P.float()
    new_P = new_P / torch.linalg.norm(new_P, dim=(-2, -1), keepdim=True)
    new_P_inv = P_inv.float() @ torch.linalg.inv(mats)
    new_P_inv = new_P_inv / torch.linalg.norm(new_P_inv, dim=(-2, -1), keepdim=True)
    return new_P.to(P.dtype), new_P_inv.to(P_inv.dtype)


# ---------------------------------------------------------------------------
# Feature Transform Layer (disentangled model)
# ---------------------------------------------------------------------------
def ftl_project(latent: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """FTL: the channels of an NHWC latent (..., H, W, 4G) as G homogeneous
    4-vectors, each multiplied by its sample's (..., 3, 4) camera:
    (..., H, W, 3G) (pytorch/CNNs.py:329-339)."""
    *lead, h, w, c = latent.shape
    z = latent.reshape(*lead, h, w, c // 4, 4)
    out = torch.einsum("...hwgj,...ij->...hwgi", z, P)
    return out.reshape(*lead, h, w, c // 4 * 3)


def ftl_inverse(latent: torch.Tensor, P_inv: torch.Tensor) -> torch.Tensor:
    """Inverse FTL: groups of 3 channels through each sample's (..., 4, 3)
    pseudo-inverse camera into groups of 4 (pytorch/CNNs.py:343-352)."""
    *lead, h, w, c = latent.shape
    z = latent.reshape(*lead, h, w, c // 3, 3)
    out = torch.einsum("...hwgj,...ij->...hwgi", z, P_inv)
    return out.reshape(*lead, h, w, c // 3 * 4)
