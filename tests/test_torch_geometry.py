"""The port's 3D lifting vs the JAX one (infer.lift_to_3d, ops/geometry.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_estimation_amitai_torch import infer as tinfer
from pose_estimation_amitai_torch.ops import geometry as tg
from pose_estimation_amitai_tpu import infer as jinfer
from pose_estimation_amitai_tpu.ops import geometry as jg


def _cameras(rng):
    """Four DLT cameras 25 cm from the origin, f = 3000 px."""
    cams = []
    for yaw in (0.1, 1.6, 3.1, 4.7):
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        center = rot.T @ np.array([0.0, 0.0, -0.25])
        k = np.array([[3000.0, 0, 640], [0, 3000.0, 400], [0, 0, 1]])
        p = k @ np.hstack([rot, -(rot @ center)[:, None]])
        cams.append(p + rng.normal(0, 1e-3, p.shape))
    return np.stack(cams).astype(np.float32)


def _scene(seed=0, frames=3, n=7):
    rng = np.random.default_rng(seed)
    cams = _cameras(rng)
    pts3d = rng.uniform(-0.004, 0.004, (frames, n, 3))
    hom = np.concatenate([pts3d, np.ones((frames, n, 1))], -1)
    uvw = np.einsum("cij,fnj->fcni", cams.astype(np.float64), hom)
    uv = uvw[..., :2] / uvw[..., 2:3]
    crop = rng.uniform(200, 300, (frames, 4, 2)).round()
    local = np.stack([uv[..., 0] - crop[..., 1:2],
                      801 - uv[..., 1] - crop[..., 0:1]], -1)
    return local.astype(np.float32), crop.astype(np.float32), cams, pts3d


def test_lift_to_3d_matches_jax():
    local, crop, cams, pts3d = _scene()
    got = tinfer.lift_to_3d(local, crop, cams, device="cpu")
    want = jinfer.lift_to_3d(local, crop, cams)
    assert got.shape == want.shape == pts3d.shape
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, pts3d, atol=1e-5)


def test_uncrop_points_matches_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 192, (4, 9, 2)).astype(np.float32)
    crop = rng.uniform(0, 600, (4, 2)).astype(np.float32)
    got = tg.uncrop_points(torch.from_numpy(pts), torch.from_numpy(crop))
    want = jg.uncrop_points(jnp.asarray(pts), jnp.asarray(crop))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pair", [(0, 1), (1, 3)])
def test_triangulate_pair_matches_jax(pair):
    local, crop, cams, _ = _scene(seed=2, frames=1, n=11)
    full = np.array(jg.uncrop_points(jnp.asarray(local[0]), jnp.asarray(crop[0])))
    a, b = pair
    got = tg.triangulate_pair(*(torch.from_numpy(v) for v in (
        cams[a], cams[b], full[a], full[b])))
    want = jg.triangulate_pair(cams[a], cams[b], full[a], full[b])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------------------
# the disentangled models' cameras and FTL: the JAX functions as the
# reference, float32, matrices compared at unit Frobenius norm (JAX's own
# normalisation), estimated cameras by reprojection
# ---------------------------------------------------------------------------
CAM_RTOL = 1e-5  # of a matrix at unit Frobenius norm
REPROJ_PX = 1e-3


def _unit(m):
    m = np.asarray(m, np.float64)
    return m / np.linalg.norm(m, axis=(-2, -1), keepdims=True)


def _project(P, pts3d):
    hom = np.concatenate([pts3d, np.ones((*pts3d.shape[:-1], 1))], -1)
    uvw = hom @ np.asarray(P, np.float64).T
    return uvw[..., :2] / uvw[..., 2:3]


def test_estimate_projection_dlt_matches_jax():
    rng = np.random.default_rng(3)
    cam = np.array([[2.0, 0.1, 0.3, 0.2], [0.05, 1.8, -0.4, 0.1], [0.1, -0.2, 0.9, 4.0]])
    pts3d = rng.uniform(-1, 1, (12, 3))
    pts2d = _project(cam, pts3d)
    got = tg.estimate_projection_dlt(torch.tensor(pts3d, dtype=torch.float32),
                                     torch.tensor(pts2d, dtype=torch.float32)).numpy()
    want = np.asarray(jg.estimate_projection_dlt(jnp.asarray(pts3d, jnp.float32),
                                                 jnp.asarray(pts2d, jnp.float32)))
    assert got[2, 3] == 1.0
    np.testing.assert_allclose(_unit(got), _unit(want), atol=CAM_RTOL)
    np.testing.assert_allclose(_project(got, pts3d), pts2d, atol=REPROJ_PX)


def test_rq3_and_decompose_camera_match_jax():
    cams = _cameras(np.random.default_rng(4))
    a = torch.from_numpy(cams[:, :, :3] / 3000.0)
    r, q = tg.rq3(a)
    for i in range(4):
        jr, jq = jg.rq3(jnp.asarray(a[i].numpy()))
        np.testing.assert_allclose(r[i].numpy(), np.asarray(jr), atol=CAM_RTOL)
        np.testing.assert_allclose(q[i].numpy(), np.asarray(jq), atol=CAM_RTOL)
    np.testing.assert_allclose((r @ q).numpy(), a.numpy(), atol=1e-5)
    K, R, t = tg.decompose_camera(torch.from_numpy(cams))
    for i in range(4):
        jk, jr, jt = jg.decompose_camera(jnp.asarray(cams[i]))
        np.testing.assert_allclose(_unit(K[i].numpy()), _unit(jk), atol=CAM_RTOL)
        np.testing.assert_allclose(R[i].numpy(), np.asarray(jr), atol=CAM_RTOL)
        np.testing.assert_allclose(t[i].numpy(), np.asarray(jt),
                                   atol=CAM_RTOL * np.abs(np.asarray(jt)).max())


def test_crop_adjusted_matrices_match_jax():
    cams = _cameras(np.random.default_rng(5))
    crop = np.random.default_rng(6).uniform(100, 500, (3, 4, 2)).round().astype(np.float32)
    Ks, Rs, ts = tg.decompose_camera(torch.from_numpy(cams))
    P, P_inv = tg.crop_adjusted_matrices(Ks, Rs, ts, torch.from_numpy(crop), crop_size=48)
    assert P.shape == (3, 4, 3, 4) and P_inv.shape == (3, 4, 4, 3)
    jK, jR, jt = jax.vmap(jg.decompose_camera)(jnp.asarray(cams))
    for f in range(3):
        jP, jPi = jg.crop_adjusted_matrices(jK, jR, jt, jnp.asarray(crop[f]), crop_size=48)
        np.testing.assert_allclose(_unit(P[f].numpy()), _unit(jP), atol=CAM_RTOL)
        np.testing.assert_allclose(_unit(P_inv[f].numpy()), _unit(jPi), atol=CAM_RTOL)


def test_compose_affine_into_cameras_matches_jax():
    rng = np.random.default_rng(7)
    P = _unit(rng.standard_normal((2, 4, 3, 4))).astype(np.float32)
    P_inv = np.linalg.pinv(P).astype(np.float32)
    th = rng.uniform(-0.5, 0.5, (2, 4))
    mats = np.zeros((2, 4, 3, 3), np.float32)
    mats[..., 0, 0], mats[..., 0, 1] = np.cos(th), -np.sin(th)
    mats[..., 1, 0], mats[..., 1, 1] = np.sin(th), np.cos(th)
    mats[..., :2, 2], mats[..., 2, 2] = rng.uniform(-5, 5, (2, 4, 2)), 1.0
    got = tg.compose_affine_into_cameras(*map(torch.from_numpy, (mats, P, P_inv)), crop_size=48)
    want = jg.compose_affine_into_cameras(*map(jnp.asarray, (mats, P, P_inv)), crop_size=48)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=CAM_RTOL)


@pytest.mark.parametrize("fn, group, cam", [("ftl_project", 4, (3, 4)),
                                            ("ftl_inverse", 3, (4, 3))])
def test_ftl_matches_jax(fn, group, cam):
    rng = np.random.default_rng(8)
    latent = rng.standard_normal((2, 5, 6, 8 * group)).astype(np.float32)
    cams = rng.standard_normal((2, *cam)).astype(np.float32)
    got = getattr(tg, fn)(torch.from_numpy(latent), torch.from_numpy(cams)).numpy()
    want = np.asarray(getattr(jg, fn)(jnp.asarray(latent), jnp.asarray(cams)))
    assert got.shape == want.shape == (2, 5, 6, 8 * (7 - group))
    np.testing.assert_allclose(got, want, atol=CAM_RTOL)


def _dlt64(pts3d, pts2d):
    """The exact DLT fit: the system's null vector in float64."""
    x, y = pts2d[:, 0], pts2d[:, 1]
    X = np.concatenate([pts3d, np.ones((len(pts3d), 1))], 1)
    zero = np.zeros_like(X)
    A = np.concatenate([np.concatenate([-X, zero, x[:, None] * X], 1),
                        np.concatenate([zero, -X, y[:, None] * X], 1)])
    p = np.linalg.svd(A)[2][-1].reshape(3, 4)
    return p / p[2, 3]


@pytest.mark.parametrize("crop_local", [False, True])
def test_estimate_cameras_from_peaks_reproject_as_the_exact_fit(crop_local):
    """The per-frame DLT fits to the decoded peaks (border filter, the
    fall-back below 6 points) reproject the 3D points within 1e-3 px of the
    float64 fit of the same correspondences, and no further from it than
    JAX's float32 fits (which are up to about a pixel off here on the
    crop-local peaks: millimetre points beside pixel coordinates)."""
    from pose_estimation_amitai_torch.data import make_synthetic_arrays
    from pose_estimation_amitai_torch.data.pipeline import estimate_cameras_from_peaks
    from pose_estimation_amitai_torch.data.preprocess import find_peaks_np
    from pose_estimation_amitai_tpu.data.pipeline import (
        estimate_cameras_from_peaks as jestimate,
    )

    arrays = make_synthetic_arrays(num_frames=2, num_points=16, image_size=48, seed=1)
    cm, cz, pts = arrays["confmaps"], arrays["cropZone"], arrays["points_3D"]
    P, P_inv = estimate_cameras_from_peaks(cm, cz, pts, crop_local=crop_local)
    jP, _ = jestimate(cm, cz, pts, crop_local=crop_local)
    assert P.shape == (2, 4, 3, 4) and P_inv.shape == (2, 4, 4, 3) and P.dtype == np.float32
    np.testing.assert_allclose(P_inv, np.linalg.pinv(P), rtol=1e-6)
    h, w = cm.shape[2:4]
    for f in range(2):
        for c in range(4):
            peaks = find_peaks_np(cm[f, c][None])[0, :2].T.astype(np.float64)
            ok = (peaks[:, 0] > 0) & (peaks[:, 0] < w - 1) & (peaks[:, 1] > 0) & (
                peaks[:, 1] < h - 1)
            ok = ok if ok.sum() >= 6 else np.ones(len(ok), bool)
            if crop_local:
                seen = np.stack([peaks[:, 0], h - peaks[:, 1]], -1)
            else:
                seen = np.stack([peaks[:, 0] + cz[f, c, 1],
                                 801 - (peaks[:, 1] + cz[f, c, 0])], -1)
            exact = _project(_dlt64(pts[f][ok].astype(np.float64), seen[ok]), pts[f])
            ours = np.abs(_project(P[f, c], pts[f]) - exact).max()
            theirs = np.abs(_project(jP[f, c], pts[f]) - exact).max()
            assert ours <= REPROJ_PX and ours <= theirs + REPROJ_PX, (f, c, ours, theirs)
