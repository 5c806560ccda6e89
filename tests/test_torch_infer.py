"""The port's Predictor vs the JAX Predictor on its default flax route
(compute_dtype float32), for all three decodes on both port routes, plus
the flax-checkpoint reader and the options the port refuses so far (the int8
routes are in tests/test_torch_quantized.py).

Chunk 2 over 5 frames, so the last chunk is zero-padded and its padded row
dropped. The JAX fused route has no interpret switch, so it cannot run on
the CPU; the port's fused route runs its kernels' plain versions here."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from pose_estimation_amitai_torch import infer as tinfer
from pose_estimation_amitai_torch import weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_tpu import infer as jinfer
from pose_estimation_amitai_tpu.train import checkpoint as jckpt

SHAPE = (48, 48, 4)
K = 6
CFG = Config(num_base_filters=8, compute_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    frames = rng.random((5, *SHAPE)).astype(np.float32)
    params = weights.init_basicnet_params(rng, SHAPE[-1], K, filters=8)
    return frames, params


@pytest.fixture(scope="module")
def jax_results(setup):
    frames, params = setup
    out = {}
    for decode in tinfer.DECODES:
        pred = jinfer.Predictor(
            CFG, jax.tree_util.tree_map(jnp.asarray, params), SHAPE, K,
            chunk_size=2, return_heatmaps=True, decode=decode,
        )
        assert pred.serving_path == "flax"
        maps, pts = pred(frames)
        out[decode] = (np.asarray(maps), np.asarray(pts))
    return out


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("decode", tinfer.DECODES)
def test_predictor_matches_jax(setup, jax_results, decode, use_fused):
    frames, params = setup
    pred = tinfer.Predictor(CFG, params, SHAPE, K, device="cpu", chunk_size=2,
                            return_heatmaps=True, decode=decode,
                            use_fused=use_fused)
    assert pred.serving_path == ("fused" if use_fused else "module")
    maps, pts = pred(frames)
    want_maps, want_pts = jax_results[decode]
    assert maps.shape == want_maps.shape == (5, *SHAPE[:2], K)
    assert pts.shape == want_pts.shape == (5, 3, K)
    np.testing.assert_allclose(maps, want_maps, atol=2e-5)
    if decode == "argmax":
        np.testing.assert_array_equal(pts[:, :2], want_pts[:, :2])
        np.testing.assert_allclose(pts[:, 2], want_pts[:, 2], atol=2e-5)
    else:
        np.testing.assert_allclose(pts, want_pts, atol=1e-4)


@pytest.mark.parametrize("dilation", [1, 2, 3])
def test_use_fused_routes_as_jax(setup, dilation):
    """use_fused serves through the kernels only at the flagship geometry
    (kernel 3, dilation 2), as JAX's Predictor does; other dilations take
    the module route, and agree with JAX's flax route."""
    frames, params = setup
    cfg = CFG.replace(dilation_rate=dilation)
    want = jinfer.Predictor(cfg, jax.tree_util.tree_map(jnp.asarray, params),
                            SHAPE, K, chunk_size=2, return_heatmaps=True,
                            use_fused=True)
    pred = tinfer.Predictor(cfg, params, SHAPE, K, device="cpu", chunk_size=2,
                            return_heatmaps=True, use_fused=True)
    assert (want.serving_path, pred.serving_path) == (
        ("fused", "fused") if dilation == 2 else ("flax", "module"))
    assert (pred.model is None) == (dilation == 2)
    if dilation != 2:  # the JAX fused route cannot run on the CPU
        np.testing.assert_allclose(pred(frames)[0], np.asarray(want(frames)[0]),
                                   atol=2e-5)


def test_predict_movie_and_peaks_only(setup):
    frames, params = setup
    pred = tinfer.Predictor(CFG, params, SHAPE, K, device="cpu", chunk_size=2,
                            use_fused=True)
    pts = pred(frames)
    assert pts.shape == (5, 3, K)
    np.testing.assert_array_equal(pred.predict_movie(frames, prefetch=2), pts)
    np.testing.assert_array_equal(pred(frames[:1]), pts[:1])
    assert pred.predict_movie(frames[:0]).shape == (0, 3, K)
    with pytest.raises(ValueError, match="peaks only"):
        tinfer.Predictor(CFG, params, SHAPE, K, device="cpu",
                         return_heatmaps=True).predict_movie(frames)


def test_bf16_fused_close_to_module(setup):
    """bf16 compute on the CPU: the two routes round at other places, so
    they agree to bf16 precision, not exactly."""
    frames, params = setup
    cfg = Config(num_base_filters=8)
    outs = [tinfer.Predictor(cfg, params, SHAPE, K, device="cpu", use_fused=f,
                             return_heatmaps=True)(frames)[0] for f in (False, True)]
    np.testing.assert_allclose(outs[1], outs[0], atol=3e-2 * np.abs(outs[0]).max())


@pytest.mark.parametrize("kind", ["params", "full", "bf16"])
def test_load_flax_checkpoint_round_trip(tmp_path, setup, kind):
    frames, params = setup
    path = str(tmp_path / "ckpt.msgpack")
    want = params
    if kind == "params":
        jckpt.save_params(path, jax.tree_util.tree_map(jnp.asarray, params))
    elif kind == "full":
        payload = {"step": np.int32(7), "params": params,
                   "opt_state": {"mu": params, "count": np.int32(7)},
                   "batch_stats": {}, "rng": np.arange(2, dtype=np.uint32)}
        with open(path, "wb") as f:
            f.write(serialization.to_bytes(payload))
    else:
        bf = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.bfloat16), params)
        jckpt.save_params(path, bf)
        want = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), bf)
    got, batch_stats = weights.load_flax_checkpoint(path)
    assert batch_stats == {}
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    pred = tinfer.Predictor.from_checkpoint(CFG, path, SHAPE, K, device="cpu",
                                            chunk_size=2)
    ref = tinfer.Predictor(CFG, want, SHAPE, K, device="cpu", chunk_size=2)
    np.testing.assert_array_equal(pred(frames), ref(frames))


@pytest.mark.parametrize("kw, item", [
    # int8 serving is ported for the flagship geometry only
    ({"use_quantized": True, "calibration_frames": np.zeros((1, *SHAPE), np.float32),
      "cfg": CFG.replace(dilation_rate=1)}, "item 11"),
    ({"mesh": object()}, "item 14"),
    ({"cameras": (np.zeros((1, 4, 3, 4)), np.zeros((1, 4, 4, 3)))}, "item 10"),
    ({"batch_stats": {"bn": {"mean": np.zeros(3)}}}, "item 10"),
])
def test_unported_options_raise(setup, kw, item):
    _, params = setup
    kw = dict(kw)
    cfg = kw.pop("cfg", CFG)
    with pytest.raises(NotImplementedError, match=item):
        tinfer.Predictor(cfg, params, SHAPE, K, device="cpu", **kw)


def test_device_is_required_and_decode_checked(setup):
    _, params = setup
    with pytest.raises(TypeError):
        tinfer.Predictor(CFG, params, SHAPE, K)
    with pytest.raises(ValueError, match="decode"):
        tinfer.Predictor(CFG, params, SHAPE, K, device="cpu", decode="median")
