"""The port's peak decodes vs the JAX ones (ops/peaks.py), cases mirroring
tests/test_ops_peaks.py: ties, a NaN channel, bf16 maps, the refined and
soft decodes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_estimation_amitai_torch.ops import peaks as tp
from pose_estimation_amitai_tpu.ops import gaussian
from pose_estimation_amitai_tpu.ops import peaks as jp


def _both(fn_name, maps_np, jdtype=jnp.float32, tdtype=torch.float32):
    got = getattr(tp, fn_name)(torch.from_numpy(maps_np).to(tdtype))
    want = getattr(jp, fn_name)(jnp.asarray(maps_np, jdtype))
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("fn", ["find_peaks_with_vals", "find_peaks"])
def test_argmax_decode_matches_jax(fn):
    maps = np.random.default_rng(0).random((4, 24, 20, 5)).astype(np.float32)
    got, want = _both(fn, maps)
    np.testing.assert_array_equal(got, want)


def test_ties_go_to_first_occurrence():
    maps = np.zeros((2, 16, 16, 3), np.float32)
    maps[0, 3, 7, 0] = maps[0, 3, 9, 0] = maps[0, 11, 2, 0] = 1.0  # 3-way tie
    maps[1, :, :, 1] = 0.5  # constant channel: first pixel
    got, want = _both("find_peaks_with_vals", maps)
    np.testing.assert_array_equal(got, want)
    assert got[0, :2, 0].tolist() == [7.0, 3.0]
    assert got[1, :2, 1].tolist() == [0.0, 0.0]
    assert got[0, :2, 2].tolist() == [0.0, 0.0]  # all-zero channel


def test_nan_channel_clamps_to_last_pixel():
    maps = np.random.default_rng(1).random((2, 12, 10, 3)).astype(np.float32)
    maps[1, 4, 5, 2] = np.nan
    got, want = _both("find_peaks_with_vals", maps)
    np.testing.assert_array_equal(got, want)  # NaN == NaN under this assert
    assert got[1, 0, 2] == 9.0 and got[1, 1, 2] == 11.0  # h*w - 1
    assert np.isnan(got[1, 2, 2])
    assert np.isfinite(got[0]).all() and np.isfinite(got[1, :, :2]).all()


def test_bf16_maps():
    maps = np.random.default_rng(2).random((3, 16, 16, 4)).astype(np.float32)
    got, want = _both("find_peaks_with_vals", maps, jnp.bfloat16, torch.bfloat16)
    np.testing.assert_array_equal(got, want)


def test_refined_matches_jax_on_gaussians():
    pts = np.array([[[40.3, 80.7], [100.5, 30.2], [0.0, 5.0]]], np.float32)
    maps = np.asarray(
        gaussian.confmaps_from_peaks(jnp.asarray(pts), (128, 128), sigma=3.0)
    )
    maps = np.concatenate([maps, np.zeros_like(maps[..., :1])], axis=-1)
    got, want = _both("find_peaks_refined", maps)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got[0, :2, :2].T, pts[0, :2], atol=1e-3)


def test_refined_matches_jax_on_random_maps():
    maps = np.random.default_rng(3).random((2, 20, 20, 6)).astype(np.float32)
    maps[0, ..., 0] -= 2.0  # non-positive channel: integer fallback
    got, want = _both("find_peaks_refined", maps)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_soft_argmax_matches_jax():
    rng = np.random.default_rng(4)
    maps = rng.random((3, 24, 32, 5)).astype(np.float32) ** 4
    maps[1, ..., 2] = 0.0  # all-zero channel: finite coordinate
    got, want = _both("find_peaks_soft_argmax", maps)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.isfinite(got).all()
