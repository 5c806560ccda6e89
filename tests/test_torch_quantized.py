"""The port's calibrated int8 serving (models/quantized.py and the int8
routes of Predictor) vs the JAX package, on the CPU.

Same seeded weights and frames on both sides: (2, 48, 48, 4) frames, filters
8 (32 for one fused case), 6 maps. ``calibrate`` is compared first; every
later test feeds both sides the JAX scales as Python floats, so a last-bit
difference in a scale cannot leak into the int8 arithmetic.

JAX rounds where its source says only when it runs op by op. Inside one
jitted computation XLA on the CPU drops ``f32 -> bf16 -> f32`` round trips
by default (``xla_allow_excess_precision``), so a requant sees an unrounded
input, and it contracts a multiply-add into one rounding. So the bf16 and
resident forwards are run op by op, where the port equals them bit for bit;
the fused forward, whose Pallas kernel (interpret mode) must be compiled, is
jitted with excess precision off, and differs from the port by the last
dequant's contracted multiply-add alone: one float32 ulp. The JAX Predictor
jits with the defaults, and is held to the tolerance the JAX package's own
tests set between two of its int8 forwards. Nothing in the JAX package
changes for any of this.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_estimation_amitai_torch import infer as tinfer
from pose_estimation_amitai_torch import weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.models import quantized as tq
from pose_estimation_amitai_tpu import infer as jinfer
from pose_estimation_amitai_tpu.models import quantized as jq
from pose_estimation_amitai_tpu.models.cnn import BasicNet as JaxBasicNet

SHAPE = (48, 48, 4)
K = 6
LAYERS = [f"conv{i}" for i in range(1, 10)] + [f"deconv{i}" for i in range(1, 5)]
# Predictor vs the JAX Predictor (jitted with excess precision): of max|JAX
# maps|, the limit of tests/test_pallas_qconv.py between two int8 forwards
MAP_RTOL = 5e-2


def strict(fn, *args):
    """``fn(*args)`` jitted with bf16 roundings kept where the source has
    them."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _setup(filters: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    frames = rng.random((2, *SHAPE)).astype(np.float32)
    params = weights.init_basicnet_params(rng, SHAPE[-1], K, filters=filters)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    scales = {k: float(v) for k, v in jq.calibrate(jparams, frames, batch=2).items()}
    model = JaxBasicNet(out_channels=K, filters=filters, dtype=jnp.float32)
    return dict(frames=frames, params=params, jparams=jparams, scales=scales,
                model=model)


@pytest.fixture(scope="module")
def net8():
    return _setup(8)


def test_reference_forward_matches_jax(net8):
    """The float32 forward calibration runs on: summation order only."""
    want = np.asarray(jq.reference_forward(net8["jparams"], jnp.asarray(net8["frames"])))
    got = tq.reference_forward(net8["params"], torch.from_numpy(net8["frames"])).numpy()
    assert got.shape == want.shape == (2, 48, 48, K)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_calibrate_matches_jax(net8):
    """Scales = amax / 127 of each layer's input: float conv summation order
    moves an amax in its last bits, hence rtol 1e-5."""
    got = tq.calibrate(net8["params"], net8["frames"], batch=2, device="cpu")
    assert list(got) == list(net8["scales"]) and sorted(got) == sorted(LAYERS)
    for name in LAYERS:
        assert isinstance(got[name], float)
        np.testing.assert_allclose(got[name], net8["scales"][name], rtol=1e-5)
    assert got["conv1"] == float(np.float32(net8["frames"].max())) / 127.0


def test_calibrate_reads_at_most_four_batches(net8):
    """Frames beyond 4 * batch are not read, as in JAX: a bright ninth frame
    changes nothing at batch 2, and changes conv1's scale at batch 3."""
    frames = np.concatenate([np.repeat(net8["frames"], 4, axis=0),
                             np.full((1, *SHAPE), 50.0, np.float32)])
    base = tq.calibrate(net8["params"], frames[:8], batch=2, device="cpu")
    assert tq.calibrate(net8["params"], frames, batch=2, device="cpu") == base
    want = jq.calibrate(net8["jparams"], frames, batch=3)
    got = tq.calibrate(net8["params"], frames, batch=3, device="cpu")
    assert got["conv1"] == want["conv1"] == 50.0 / 127.0


@pytest.mark.parametrize("name", LAYERS)
def test_quantize_params_equals_jax(net8, name):
    """int8 weights equal; multipliers, biases and s_x equal bit for bit."""
    want = jq.quantize_params(net8["jparams"], net8["scales"])[name]
    got = tq.quantize_params(net8["params"], net8["scales"])[name]
    assert sorted(got) == sorted(want) == ["bias", "mult", "s_x", "w_q"]
    assert got["w_q"].dtype == np.int8 and got["mult"].dtype == np.float32
    assert got["bias"].dtype == np.float32
    np.testing.assert_array_equal(got["w_q"], np.asarray(want["w_q"]))
    assert got["mult"].tobytes() == np.asarray(want["mult"]).tobytes()
    assert got["bias"].tobytes() == np.asarray(want["bias"]).tobytes()
    assert got["s_x"] == want["s_x"]


def test_quantize_params_floors_zero_scales(net8):
    """A blank calibration set (all scales 0) and a dead output channel give
    finite multipliers, as JAX's floors at 1e-12 do."""
    params = {k: {n: dict(l) for n, l in v.items()} for k, v in net8["params"].items()}
    w = np.array(params["encoder"]["conv2"]["kernel"])
    w[..., 3] = 0.0
    params["encoder"]["conv2"]["kernel"] = w
    zero = dict.fromkeys(LAYERS, 0.0)
    got = tq.quantize_params(params, zero)
    want = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, params), zero)
    for name in LAYERS:
        assert got[name]["s_x"] == want[name]["s_x"] == 1e-12
        assert got[name]["mult"].tobytes() == np.asarray(want[name]["mult"]).tobytes()
        np.testing.assert_array_equal(got[name]["w_q"], np.asarray(want[name]["w_q"]))
    assert not got["conv2"]["w_q"][..., 3].any()


def _jax_forward(net, kind: str):
    m, p, s = net["model"], net["jparams"], net["scales"]
    if kind == "bf16":
        return jq.make_quantized_forward(m, p, s)
    if kind == "resident":
        return jq.make_quantized_resident_forward(m, p, s, out_dtype=jnp.float32)
    return jq.make_quantized_fused_forward(m, p, s, interpret=True)


def _port_forward(net, kind: str):
    make = {"bf16": tq.make_quantized_forward,
            "resident": tq.make_quantized_resident_forward,
            "fused": tq.make_quantized_fused_forward}[kind]
    return make(net["params"], net["scales"], device="cpu", out_dtype=torch.float32)


@pytest.mark.parametrize("kind", ["bf16", "resident"])
def test_forward_equals_jax_op_by_op(net8, kind):
    """float32 maps out, JAX run op by op: every element equal."""
    want = np.asarray(_jax_forward(net8, kind)(jnp.asarray(net8["frames"])))
    got = _port_forward(net8, kind)(torch.from_numpy(net8["frames"])).numpy()
    assert got.shape == want.shape == (2, 48, 48, K) and got.dtype == np.float32
    assert np.abs(want).max() > 0.5
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filters, seed", [(8, 0), (32, 1)])
def test_fused_forward_matches_jax(net8, filters, seed):
    """The fused forward vs JAX's through the Pallas kernel in interpret
    mode, float32 maps out, at filters 8 and at the width of the JAX
    package's own fused test (32: the kernel's input slabs hold 32, 64 and
    128 real channels). Every int8 value is equal; XLA contracts deconv4's
    ``acc * mult + bias`` into one rounding, so the maps are held to two
    float32 ulps of their max (1e-7 of it, where 1e-2 was allowed)."""
    net = net8 if filters == 8 else _setup(filters, seed)
    want = np.asarray(strict(_jax_forward(net, "fused"), jnp.asarray(net["frames"])))
    got = _port_forward(net, "fused")(torch.from_numpy(net["frames"])).numpy()
    assert got.shape == want.shape == (2, 48, 48, K) and got.dtype == np.float32
    top = np.float32(np.abs(want).max())
    assert top > 0.5 and np.abs(got - want).max() <= 2 * np.spacing(top)


def test_fused_forward_tracks_bf16_forward(net8):
    """The tolerance of the JAX package's fused test, between the port's own
    two forwards: same scales and skip precision, so the maps agree to a
    couple of int8 quanta."""
    x = torch.from_numpy(net8["frames"])
    ref = _port_forward(net8, "bf16")(x).numpy()
    got = _port_forward(net8, "fused")(x).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.05
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999


def test_resident_forward_rounds_maps_to_bf16(net8):
    """The served form: bf16 maps are the float32 maps rounded once."""
    x = torch.from_numpy(net8["frames"])
    f32 = _port_forward(net8, "resident")(x)
    served = tq.make_quantized_resident_forward(
        net8["params"], net8["scales"], device="cpu")(x)
    assert served.dtype == torch.bfloat16
    assert torch.equal(served, f32.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# Predictor
# ---------------------------------------------------------------------------
CFG = Config(num_base_filters=8, compute_dtype="float32")


@pytest.fixture(scope="module")
def frames5():
    return np.random.default_rng(3).random((5, *SHAPE)).astype(np.float32)


@pytest.mark.parametrize("use_fused, path", [(False, "int8_resident"),
                                             (True, "int8_fused")])
def test_predictor_int8_routes(net8, frames5, use_fused, path):
    """use_quantized alone serves the resident forward, as JAX does; with
    use_fused the fused forward (a route of the port: JAX ignores use_fused
    here). Chunk 2 over 5 frames: the padded tail row is dropped, and
    predict_movie gives the same peaks."""
    pred = tinfer.Predictor(CFG, net8["params"], SHAPE, K, device="cpu",
                            chunk_size=2, use_quantized=True, use_fused=use_fused,
                            calibration_frames=frames5, return_heatmaps=True)
    assert pred.serving_path == path and pred.model is None
    maps, pts = pred(frames5)
    assert maps.shape == (5, 48, 48, K) and maps.dtype == np.float32
    assert pts.shape == (5, 3, K) and np.isfinite(pts).all()
    scales = tq.calibrate(net8["params"], frames5, device="cpu")
    if use_fused:
        fwd = tq.make_quantized_fused_forward(net8["params"], scales, device="cpu")
    else:
        fwd = tq.make_quantized_resident_forward(net8["params"], scales, device="cpu")
    want = fwd(torch.from_numpy(frames5[:2])).float().numpy()
    np.testing.assert_array_equal(maps[:2], want)
    peaks_only = tinfer.Predictor(CFG, net8["params"], SHAPE, K, device="cpu",
                                  chunk_size=2, use_quantized=True,
                                  use_fused=use_fused, calibration_frames=frames5)
    np.testing.assert_array_equal(peaks_only(frames5), pts)
    np.testing.assert_array_equal(peaks_only.predict_movie(frames5, prefetch=2), pts)


def test_predictor_int8_resident_matches_jax(net8, frames5):
    """Both Predictors calibrate for themselves and serve bf16 maps. JAX
    jits its forward with XLA's default excess precision, so some requants
    see unrounded inputs there: the maps are held to 5% of the max, and the
    argmax peaks are equal wherever the JAX map's top-two gap exceeds twice
    that, where no such error can move the argmax. On these seeded random
    weights the maps are flat and few gaps are that wide, so every peak is
    also held to what the map tolerance implies: at the port's peak the JAX
    map lies within twice the tolerance of its own maximum."""
    want = jinfer.Predictor(CFG, net8["jparams"], SHAPE, K, chunk_size=2,
                            return_heatmaps=True, use_quantized=True,
                            calibration_frames=frames5)
    assert want.serving_path == "int8_resident"
    wm, wp = (np.asarray(a) for a in want(frames5))
    pred = tinfer.Predictor(CFG, net8["params"], SHAPE, K, device="cpu",
                            chunk_size=2, return_heatmaps=True,
                            use_quantized=True, calibration_frames=frames5)
    gm, gp = pred(frames5)
    tol = MAP_RTOL * np.abs(wm).max()
    assert np.abs(gm - wm).max() <= tol
    top2 = np.sort(wm.reshape(5, -1, K), axis=1)[:, -2:]  # (5, 2, K)
    clear = (top2[:, 1] - top2[:, 0]) > 2 * tol
    same = (gp[:, :2] == wp[:, :2]).all(axis=1)
    assert same[clear].all()
    xs, ys = gp[:, 0].astype(int), gp[:, 1].astype(int)  # (5, K)
    at_port_peak = wm[np.arange(5)[:, None], ys, xs, np.arange(K)[None, :]]
    assert (at_port_peak >= wm.max(axis=(1, 2)) - 2 * tol).all()
    assert np.abs(gp[:, 2] - wp[:, 2]).max() <= tol


def test_predictor_int8_needs_calibration_frames(net8):
    with pytest.raises(ValueError, match="calibration_frames"):
        tinfer.Predictor(CFG, net8["params"], SHAPE, K, device="cpu",
                         use_quantized=True)


@pytest.mark.parametrize("cfg", [CFG.replace(dilation_rate=1),
                                 CFG.replace(kernel_size=5)])
def test_predictor_int8_other_geometry_is_queued(net8, frames5, cfg):
    """JAX serves these through ``int8_generic``; so does the port, with or
    without use_fused, and decodes one call."""
    from pose_estimation_amitai_torch.models import build_model
    from pose_estimation_amitai_torch.train import loop

    with torch.device("meta"):
        model = build_model(cfg, SHAPE, K)
    params = weights.state_dict_to_flax(
        loop.create_train_state(model, cfg, seed=0, device="cpu").params, model)
    for use_fused in (False, True):
        pred = tinfer.Predictor(cfg, params, SHAPE, K, device="cpu", use_quantized=True,
                                use_fused=use_fused, calibration_frames=frames5)
        assert pred.serving_path == "int8_generic"
        pts = pred(frames5)
        assert pts.shape == (5, 3, K) and np.isfinite(pts).all()
