"""The port's Predictor vs the JAX Predictor on its default flax route
(compute_dtype float32), for all three decodes on both port routes, for the
flagship BasicNet and for the two ViT families, plus the flax-checkpoint
reader and the options the port refuses so far (the int8 routes are in
tests/test_torch_quantized.py).

Chunk 2 over 5 frames, so the last chunk is zero-padded and its padded row
dropped. The JAX fused route has no interpret switch, so it cannot run on
the CPU; the port's fused route runs its kernels' plain versions here."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from pose_estimation_amitai_torch import constants as C
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


@pytest.mark.parametrize("files, wins", [
    (("checkpoint.msgpack",), "checkpoint.msgpack"),
    (("checkpoint.msgpack", "best_model.msgpack"), "best_model.msgpack"),
])
def test_load_flax_checkpoint_from_run_directory(tmp_path, setup, files, wins):
    """A run directory, as the JAX ``load_variables`` takes one: the best
    snapshot if there, else the training checkpoint."""
    frames, params = setup
    trees = {}
    for i, name in enumerate(files):
        trees[name] = jax.tree_util.tree_map(lambda v: np.asarray(v) * (1.0 + i), params)
        if name == "checkpoint.msgpack":
            payload = {"step": np.int32(3), "params": trees[name],
                       "opt_state": {"count": np.int32(3)}, "batch_stats": {},
                       "rng": np.arange(2, dtype=np.uint32)}
            (tmp_path / name).write_bytes(serialization.to_bytes(payload))
        else:
            jckpt.save_params(str(tmp_path / name),
                              jax.tree_util.tree_map(jnp.asarray, trees[name]))
    got, batch_stats = weights.load_flax_checkpoint(str(tmp_path))
    assert batch_stats == {}
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(trees[wins])):
        np.testing.assert_array_equal(a, b)
    jax_params, _ = jckpt.load_variables(str(tmp_path))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jax_params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    pred = tinfer.Predictor.from_checkpoint(CFG, str(tmp_path), SHAPE, K, device="cpu",
                                            chunk_size=2)
    ref = tinfer.Predictor(CFG, trees[wins], SHAPE, K, device="cpu", chunk_size=2)
    np.testing.assert_array_equal(pred(frames), ref(frames))


def test_load_flax_checkpoint_from_an_empty_run_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match="best_model.msgpack.*checkpoint.msgpack"):
        weights.load_flax_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tinfer.Predictor.from_checkpoint(CFG, str(tmp_path), SHAPE, K, device="cpu")


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


# ---------------------------------------------------------------------------
# ViT families
# ---------------------------------------------------------------------------
VIT = {
    "single": dict(
        cfg=Config(model_type=C.MODEL_18_POINTS_PER_WING_VIT, projection_dim=64,
                   num_heads=2, transformer_layers=2, fully_connected_expand=2,
                   compute_dtype="float32"),
        shape=(48, 48, 4), k=6, four=False),
    "four": dict(
        cfg=Config(model_type=C.ALL_CAMS_18_POINTS_VIT, projection_dim=32,
                   num_heads=2, transformer_layers=1, fully_connected_expand=2,
                   compute_dtype="float32"),
        shape=(48, 48, 16), k=8, four=True),
}


@pytest.fixture(scope="module")
def vit_setup():
    out = {}
    for kind, v in VIT.items():
        rng = np.random.default_rng(7)
        cfg = v["cfg"]
        params = weights.init_vit_params(
            rng, v["shape"][-1], v["k"], 48, dim=cfg.projection_dim,
            depth=cfg.transformer_layers, heads=cfg.num_heads,
            dim_head=cfg.projection_dim, mlp_expand=2, four_cameras=v["four"])
        frames = rng.standard_normal((5, *v["shape"])).astype(np.float32)
        out[kind] = (frames, params)
    return out


def _jax_vit(kind, params, **kw):
    v = VIT[kind]
    return jinfer.Predictor(v["cfg"], jax.tree_util.tree_map(jnp.asarray, params),
                            v["shape"], v["k"], chunk_size=2, **kw)


def _port_vit(kind, params, **kw):
    v = VIT[kind]
    kw.setdefault("chunk_size", 2)
    return tinfer.Predictor(v["cfg"], params, v["shape"], v["k"], device="cpu", **kw)


@pytest.fixture(scope="module")
def vit_jax_results(vit_setup):
    out = {}
    for kind, (frames, params) in vit_setup.items():
        for decode in tinfer.DECODES:
            pred = _jax_vit(kind, params, return_heatmaps=True, decode=decode)
            assert pred.serving_path == "flax" and pred.model.fast_softmax is False
            maps, pts = pred(frames)
            out[kind, decode] = (np.asarray(maps), np.asarray(pts))
    return out


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("decode", tinfer.DECODES)
@pytest.mark.parametrize("kind", list(VIT))
def test_vit_predictor_matches_jax(vit_setup, vit_jax_results, kind, decode, use_fused):
    """Normalised float32 maps and every decode, on both of the port's
    routes (on the CPU the fused route runs the attention kernel's plain
    version), against JAX's flax route."""
    frames, params = vit_setup[kind]
    pred = _port_vit(kind, params, return_heatmaps=True, decode=decode,
                     use_fused=use_fused)
    assert pred.serving_path == ("fused" if use_fused else "module")
    maps, pts = pred(frames)
    want_maps, want_pts = vit_jax_results[kind, decode]
    k = VIT[kind]["k"]
    assert maps.shape == want_maps.shape == (5, 48, 48, k)
    assert pts.shape == want_pts.shape == (5, 3, k)
    np.testing.assert_allclose(maps, want_maps, atol=1e-4)
    if decode == "argmax":
        np.testing.assert_array_equal(pts[:, :2], want_pts[:, :2])
        np.testing.assert_allclose(pts[:, 2], want_pts[:, 2], atol=1e-5)
    else:
        np.testing.assert_allclose(pts, want_pts, atol=2e-4)


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("kind", list(VIT))
def test_vit_peaks_only_val_renorm(vit_setup, vit_jax_results, kind, use_fused):
    """Argmax peaks-only serving skips the min-max normalisation and
    recovers the val channel from the raw maps' min and max: bit-equal to
    decoding the normalised maps, and equal to JAX's peaks-only answer."""
    frames, params = vit_setup[kind]
    pred = _port_vit(kind, params, use_fused=use_fused, fast_softmax=False)
    assert pred._val_renorm_views == (4 if kind == "four" else 1)
    assert pred.model.normalize_output is False
    pts = pred(frames)
    with_maps = _port_vit(kind, params, use_fused=use_fused, fast_softmax=False,
                          return_heatmaps=True)
    assert with_maps._val_renorm_views == 0 and with_maps.model.normalize_output
    np.testing.assert_array_equal(pts, with_maps(frames)[1])
    np.testing.assert_array_equal(pred.predict_movie(frames, prefetch=2), pts)
    want = np.asarray(_jax_vit(kind, params, fast_softmax=False)(frames))
    np.testing.assert_array_equal(pts[:, :2], want[:, :2])
    np.testing.assert_allclose(pts[:, 2], want[:, 2], atol=1e-5)
    np.testing.assert_allclose(pts[:, 2], vit_jax_results[kind, "argmax"][1][:, 2],
                               atol=1e-5)


def test_vit_fast_softmax_auto_rule(vit_setup):
    """JAX's rule: None engages the bf16 chain for argmax peaks-only
    serving; False and True force it; the fused route keeps it off."""
    _, params = vit_setup["single"]
    for kw, want in [
        ({}, True), ({"return_heatmaps": True}, False), ({"decode": "soft"}, False),
        ({"fast_softmax": False}, False),
        ({"fast_softmax": True, "return_heatmaps": True}, True),
        ({"use_fused": True}, False), ({"use_fused": True, "fast_softmax": False}, False),
    ]:
        pred = _port_vit("single", params, **kw)
        jkw = {k: v for k, v in kw.items() if k != "use_fused"}
        if "use_fused" not in kw:
            assert _jax_vit("single", params, **jkw).model.fast_softmax is want
        assert pred.model.fast_softmax is want, kw
        assert pred.model.transformer.attn0.fast_softmax is want
        assert pred.model.fused_attention is bool(kw.get("use_fused"))
    with pytest.raises(ValueError, match="fast_softmax=True excludes"):
        _port_vit("single", params, use_fused=True, fast_softmax=True)


def test_vit_fast_softmax_peaks_match_jax(vit_setup):
    """The default argmax peaks-only route (bf16 chain engaged, float32
    compute here): same peaks as JAX's default."""
    frames, params = vit_setup["single"]
    pts = _port_vit("single", params)(frames)
    want = np.asarray(_jax_vit("single", params)(frames))
    np.testing.assert_array_equal(pts[:, :2], want[:, :2])
    np.testing.assert_allclose(pts[:, 2], want[:, 2], atol=1e-5)


def test_vit4cam_views_unfold_from_chunk_128(vit_setup):
    _, params = vit_setup["four"]
    assert _port_vit("four", params).model.fold_views is True
    assert _port_vit("four", params, chunk_size=127).model.fold_views is True
    assert _port_vit("four", params, chunk_size=128).model.fold_views is False
    assert _jax_vit("four", params).model.fold_views is True


def test_vit_tf_flavour_serves_unnormalised(vit_setup):
    """The tf flavour has no min-max: no val renorm, float32 maps."""
    frames, _ = vit_setup["single"]
    cfg = VIT["single"]["cfg"].replace(arch_flavor="tf")
    params = weights.init_vit_params(np.random.default_rng(3), 4, 6, 48, dim=64, depth=2,
                                     heads=2, dim_head=64, mlp_expand=2, flavor="tf")
    pred = tinfer.Predictor(cfg, params, (48, 48, 4), 6, device="cpu", chunk_size=2,
                            fast_softmax=False)
    assert pred._val_renorm_views == 0 and pred.serving_path == "module"
    want = jinfer.Predictor(cfg, jax.tree_util.tree_map(jnp.asarray, params),
                            (48, 48, 4), 6, chunk_size=2, fast_softmax=False)
    got, ref = pred(frames), np.asarray(want(frames))
    np.testing.assert_array_equal(got[:, :2], ref[:, :2])
    np.testing.assert_allclose(got[:, 2], ref[:, 2], atol=1e-5)


def test_vit_refusals(vit_setup):
    _, params = vit_setup["single"]
    with pytest.raises(NotImplementedError, match="item 11"):
        _port_vit("single", params, use_quantized=True,
                  calibration_frames=np.zeros((1, 48, 48, 4), np.float32))
    with pytest.raises(NotImplementedError, match="item 14"):
        _port_vit("single", {"embed": {}, "blocks": {}, "decoder": {}})


@pytest.mark.parametrize("kind", list(VIT))
def test_vit_from_checkpoint(tmp_path, vit_setup, kind):
    frames, params = vit_setup[kind]
    v = VIT[kind]
    path = str(tmp_path / "vit.msgpack")
    jckpt.save_params(path, jax.tree_util.tree_map(jnp.asarray, params))
    pred = tinfer.Predictor.from_checkpoint(v["cfg"], path, v["shape"], v["k"],
                                            device="cpu", chunk_size=2, use_fused=True)
    assert pred.serving_path == "fused"
    ref = _port_vit(kind, params, use_fused=True)
    np.testing.assert_array_equal(pred(frames), ref(frames))
