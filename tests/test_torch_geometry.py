"""The port's 3D lifting vs the JAX one (infer.lift_to_3d, ops/geometry.py)."""

import numpy as np
import pytest
import torch

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
