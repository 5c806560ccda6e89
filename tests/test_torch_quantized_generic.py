"""Generic int8 serving (models/quantized_generic.py, the Predictor's
"int8_generic" route) against JAX's ``models/quantized_generic.py`` on the
CPU at 48 px.

* Layer by layer, on the same input, weights and scale, a quantised
  ``Linear``, 3x3 conv, transposed conv (the torch crop and flax's SAME)
  and the ViT's patch conv give JAX's bits: the float64 sums of int8
  products are exact, the epilogue is JAX's.
* Calibration keys equal JAX's one for one and the scales agree within
  SCALE_RTOL, for ``ViTPoseNet`` ('all' and 'conv_only'), ``MultiCamNet``
  (tf flavour with its attention fusion: no ``DenseGeneral`` key),
  ``ResNetHeatmapNet`` (one block a stage) and ``FourCamDisentangled``,
  in float32 compute. In bf16 the float layers between the quantised ones
  round otherwise in XLA and in torch (a patch conv against an unfold +
  matmul, other summation orders), and an amax moves by a bf16 step.
* Whole-model maps of ``make_quantized_apply`` against JAX's run op by op
  under ``jax.disable_jit()`` (jitted XLA on the CPU drops the bf16 round
  trips of the activation quantiser, even in a float32 model), on JAX's
  scales: float32 models within F32_MAPS_RTOL of the
  largest map value; the served bf16 models within BF16_MAPS_RTOL with at
  least BF16_EQUAL_SHARE of the values bit-equal (an input that lands on
  the other side of a rounding boundary quantises one step away).
* An empty filter reproduces the float forward exactly; peak parity on
  trained weights (JAX's tests/test_quantized.py criteria, median <= 1 px,
  the weights trained once in JAX and bridged); the Predictor's routes
  (tests/test_serving_dispatch.py)."""

import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch import nn
from torch.func import functional_call

import jax
import jax.numpy as jnp
import optax

from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch import infer as tinfer
from pose_estimation_amitai_torch import weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.models import build_model
from pose_estimation_amitai_torch.models import quantized_generic as tq
from pose_estimation_amitai_torch.models.layers import Deconv, Dense, Conv, deconv_same_pads
from pose_estimation_amitai_torch.models.vit import PatchConv
from pose_estimation_amitai_torch.ops import peaks as tpeaks
from pose_estimation_amitai_torch.train import loop
from pose_estimation_amitai_tpu.config import Config as JConfig
from pose_estimation_amitai_tpu.data.pipeline import build_dataset as jbuild_dataset
from pose_estimation_amitai_tpu.data.synthetic import make_synthetic_arrays as jsynthetic
from pose_estimation_amitai_tpu.models import build_model as jbuild_model
from pose_estimation_amitai_tpu.models import quantized_generic as jq
from pose_estimation_amitai_tpu.ops.gaussian import confmaps_from_peaks as jconfmaps

from test_torch_resnet import one_thread  # noqa: F401 (a fixture)

SCALE_RTOL = 2e-6  # calibration scales, float32 compute (measured <= 1.2e-6)
F32_MAPS_RTOL = 1e-5  # float32 models' maps, of the largest value
BF16_MAPS_RTOL = 0.05  # bf16 models' maps, of the largest value (measured <= 0.033)
BF16_EQUAL_SHARE = 0.05  # bit-equal share of the bf16 models' map values (measured >= 0.07)
PEAK_MEDIAN_PX = 1.0  # JAX's peak-parity criterion
HW = 48


@pytest.fixture(autouse=True)
def _one_thread_here(one_thread):
    """Every case of this file on one intra-op thread (test_torch_resnet.py
    ``one_thread``: workers of the parallel run share the cores)."""


def _bridge(jparams):
    return jax.tree_util.tree_map(np.asarray, jparams)


# ---------------------------------------------------------------------------
# one layer: the port's QuantizedLayer against JAX's _apply_quantized
# ---------------------------------------------------------------------------
def _layer_case(kind, rng):
    """(flax module, its params, port layer, NHWC/token input)."""
    bf16 = jnp.bfloat16
    if kind == "dense":
        jm = fnn.Dense(24, dtype=bf16, param_dtype=jnp.float32)
        layer, x = Dense(32, 24, dtype=torch.bfloat16), rng.standard_normal((2, 9, 32))
    elif kind == "conv":
        jm = fnn.Conv(16, (3, 3), kernel_dilation=(2, 2), padding="SAME", dtype=bf16,
                      param_dtype=jnp.float32)
        layer, x = Conv(8, 16, 3, 2, dtype=torch.bfloat16), rng.standard_normal((2, 12, 12, 8))
    elif kind in ("deconv_torch", "deconv_same"):
        pads = (1, 2) if kind == "deconv_torch" else deconv_same_pads(3, 2)
        jm = fnn.ConvTranspose(16, (3, 3), strides=(2, 2), padding=(pads, pads), dtype=bf16,
                               param_dtype=jnp.float32)
        layer, x = Deconv(8, 16, 3, 2, pads, dtype=torch.bfloat16), rng.standard_normal((2, 6, 6, 8))
    else:
        jm = fnn.Conv(32, (16, 16), strides=(16, 16), padding="VALID", dtype=bf16,
                      param_dtype=jnp.float32)
        layer, x = PatchConv(4, 32, 16, torch.bfloat16), rng.random((2, 48, 48, 4))
    x = x.astype(np.float32)
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"],
              "bias": jnp.asarray(rng.standard_normal(params["bias"].shape) * 0.1, jnp.float32)}
    return jm, params, layer, x


@pytest.mark.parametrize("kind", ["dense", "conv", "deconv_torch", "deconv_same", "patch"])
def test_quantized_layer_equals_jax_bitwise(kind):
    rng = np.random.default_rng(0)
    jm, params, layer, x = _layer_case(kind, rng)
    scale = float(np.abs(x).max() / 127.0 * 0.9)  # some inputs clip
    with jax.disable_jit():
        want = np.asarray(jq.make_quantized_apply(jm, params, {"": scale})(jnp.asarray(x)))
    sd = weights.flax_to_state_dict({"l": _bridge(params)}, nn.ModuleDict({"l": layer}))
    q = tq.QuantizedLayer(layer, sd["l.weight"].float(), sd["l.bias"].float(), scale)
    xin = torch.from_numpy(x)
    if kind not in ("dense", "patch"):
        xin = xin.permute(0, 3, 1, 2)
    got = q(xin)
    if kind not in ("dense", "patch"):
        got = got.permute(0, 2, 3, 1)
    got = got.float().numpy()
    if kind == "patch":  # the conv's (B, g, g, dim) as the port's tokens
        want = want.reshape(got.shape)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_weight_scales_take_flax_last_axis():
    """Per output channel: dim 0 of a Linear or Conv2d weight, dim 1 of a
    ConvTranspose2d one, told by the module's type whatever its name."""
    w = torch.arange(2 * 3 * 1 * 1, dtype=torch.float32).reshape(2, 3, 1, 1) + 1
    assert tq.weight_scales(w, nn.Conv2d(3, 2, 1)).shape == (2,)
    assert tq.weight_scales(w, nn.ConvTranspose2d(2, 3, 1)).shape == (3,)
    torch.testing.assert_close(tq.weight_scales(w, nn.ConvTranspose2d(2, 3, 1)),
                               torch.tensor([4.0, 5.0, 6.0]) / 127.0)


# ---------------------------------------------------------------------------
# whole models: calibration keys and scales, maps
# ---------------------------------------------------------------------------
def _family(name, compute_dtype):
    """(port model, JAX model, port state_dict, flax variables, calibration
    batches) of one family at 48 px, seeded parameters with drawn biases
    and running averages."""
    from pose_estimation_amitai_torch.models import ResNetHeatmapNet
    from pose_estimation_amitai_tpu.models.resnet import ResNetHeatmapNet as JResNet

    dt = torch.float32 if compute_dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if compute_dtype == "float32" else jnp.bfloat16
    serving = {}
    if name == "resnet":
        kw = dict(flavor="tf", stem_features=16, stage_sizes=(1, 1, 1, 1))
        cin, k = 4, 6
        model, jmodel = ResNetHeatmapNet(cin, k, dtype=dt, **kw), JResNet(6, dtype=jdt, **kw)
        cfg = Config(model_type=C.RESNET_18_POINTS_PER_WING, compute_dtype=compute_dtype)
    else:
        if name == "vit":
            kw = dict(model_type=C.MODEL_18_POINTS_PER_WING_VIT, patch_size=16,
                      projection_dim=32, transformer_layers=2, num_heads=2,
                      fully_connected_expand=2, dim_head=0)
            cin, k = 4, 6
            serving = {"normalize_output": False}  # as the Predictor serves argmax peaks
        elif name == "multicam":
            kw = dict(model_type=C.ALL_CAMS_18_POINTS, arch_flavor="tf", do_attention=True,
                      num_base_filters=8, dropout_ratio=0.0)
            cin, k = 16, 12
        else:
            kw = dict(model_type=C.ALL_CAMS_DISENTANGLED_PER_WING_CNN, num_base_filters=8,
                      dropout_ratio=0.0)
            cin, k = 16, 24
        cfg = Config(compute_dtype=compute_dtype, **kw)
        model = build_model(cfg, (HW, HW, cin), k, **serving)
        jmodel = jbuild_model(JConfig(compute_dtype=compute_dtype, **kw), (HW, HW, cin), k)
        if serving:
            jmodel = jmodel.clone(**serving)
    state = loop.create_train_state(model, cfg, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(2)
    params = {n: v + 0.05 * torch.randn(v.shape, generator=gen) if v.dim() == 1 else v
              for n, v in state.params.items()}
    stats = {n: (0.5 + torch.rand(v.shape, generator=gen)) if n.endswith("var")
             else 0.1 * torch.randn(v.shape, generator=gen)
             for n, v in state.batch_stats.items()}
    variables = {"params": jax.tree_util.tree_map(
        jnp.asarray, weights.state_dict_to_flax(params, model))}
    if stats:
        variables["batch_stats"] = jax.tree_util.tree_map(
            jnp.asarray, weights.batch_stats_to_flax(stats))
    sd = {**params, **stats}
    model.load_state_dict(sd)
    rng = np.random.default_rng(3)
    frames = rng.random((16, HW, HW, cin)).astype(np.float32)
    cams = None
    if name == "disentangled":
        P = rng.standard_normal((16, 4, 3, 4))
        P /= np.linalg.norm(P, axis=(-2, -1), keepdims=True)
        P_inv = np.linalg.pinv(P)
        P_inv /= np.linalg.norm(P_inv, axis=(-2, -1), keepdims=True)
        cams = (P.astype(np.float32), P_inv.astype(np.float32))
    return model.eval(), jmodel, sd, variables, tq.calibration_batches(frames, cams, device="cpu")


def _jax_batches(batches):
    return [tuple(jnp.asarray(a.numpy()) for a in b) for b in batches]


@pytest.mark.parametrize("name, layers", [("vit", "all"), ("vit", "conv_only"),
                                          ("multicam", "all"), ("resnet", "all"),
                                          ("disentangled", "all")])
def test_calibration_scales_match_jax(name, layers):
    model, jmodel, sd, variables, batches = _family(name, "float32")
    assert len(batches) == 2 and batches[0][0].shape[0] == 8
    conv_only = layers == "conv_only"
    got = tq.calibrate_apply(model, sd, batches, tq.conv_layers_only if conv_only else None)
    want = jq.calibrate_apply(jmodel, variables, _jax_batches(batches),
                              layer_filter=jq.conv_layers_only if conv_only else None)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], float(w), rtol=SCALE_RTOL, err_msg=key)
    if name == "vit":
        depth = 2
        assert len(got) == (4 if conv_only else 1 + 4 * depth + 4), sorted(got)
        assert conv_only == all(k.startswith("decoder/deconv") for k in got)
    if name == "multicam":
        assert "fusion_attn" not in "".join(got)  # flax DenseGeneral is no nn.Dense
        assert any(k.startswith("shared_encoder/") for k in got)


@pytest.mark.parametrize("name", ["vit", "multicam", "disentangled"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_quantized_maps_match_jax_op_by_op(name, compute_dtype):
    model, jmodel, sd, variables, batches = _family(name, compute_dtype)
    scales = jq.calibrate_apply(jmodel, variables, _jax_batches(batches))
    x = batches[0]
    with jax.disable_jit():
        want = np.asarray(jq.make_quantized_apply(jmodel, variables, scales)(
            *_jax_batches([x])[0]), np.float32)
    got = tq.make_quantized_apply(model, sd, {k: float(v) for k, v in scales.items()})(
        *x).float().numpy()
    assert got.shape == want.shape
    d = np.abs(got - want)
    top = np.abs(want).max()
    if compute_dtype == "float32":
        assert d.max() <= F32_MAPS_RTOL * top, d.max() / top
    else:
        assert d.max() <= BF16_MAPS_RTOL * top, d.max() / top
        assert (d == 0).mean() >= BF16_EQUAL_SHARE, (d == 0).mean()


def test_empty_filter_reproduces_float_forward():
    """tests/test_quantized.py::test_selective_quantization_layer_filter:
    no layer selected, no layer quantised, exactly the float forward; the
    conv-only mode selects the 4 decoder deconvs and no trunk layer."""
    model, _, sd, _, batches = _family("vit", "bfloat16")
    none = tq.calibrate_apply(model, sd, batches, lambda path, m: False)
    assert none == {}
    x = batches[0][0]
    with torch.no_grad():
        ref = functional_call(model, sd, (x,))
    assert torch.equal(tq.make_quantized_apply(model, sd, none)(x), ref)
    conv = tq.calibrate_apply(model, sd, batches, tq.conv_layers_only)
    assert sorted(conv) == [f"decoder/deconv{i}" for i in range(1, 5)]
    mixed = tq.make_quantized_apply(model, sd, conv, out_dtype=torch.float32)(x)
    assert torch.isfinite(mixed).all() and not torch.equal(mixed, ref.float())


# ---------------------------------------------------------------------------
# peak parity on weights trained in JAX (tests/test_quantized.py)
# ---------------------------------------------------------------------------
def _jax_train(model, params, x, y, steps):
    tx = optax.adam(1e-3)

    @jax.jit
    def step(params, opt):
        loss, g = jax.value_and_grad(lambda p: jnp.mean(jnp.square(
            model.apply({"params": p}, x, train=False) - y)))(params)
        up, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, up), opt

    opt = tx.init(params)
    for _ in range(steps):
        params, opt = step(params, opt)
    return params


@pytest.fixture(scope="module")
def trained():
    """The three trained models of tests/test_quantized.py, trained once in
    JAX (float32): the flagship BasicNet 1200 steps, the ViT 600, the
    MultiCamNet 150. {name: (config kwargs, flax params, x, y)}."""
    out = {}
    arrays = jsynthetic(num_frames=4, num_points=8, image_size=HW, seed=5)
    kw = dict(num_base_filters=8, dropout_ratio=0.0, compute_dtype="float32")
    cfg = JConfig(**kw)
    ds, _ = jbuild_dataset(cfg, arrays)
    x = ds.data["box"][:8].astype(jnp.float32)
    y = ds.data["confmaps"][:8].astype(jnp.float32)
    m = jbuild_model(cfg, x.shape[1:], y.shape[-1])
    p = m.init({"params": jax.random.key(0)}, x, train=False)["params"]
    out["basicnet"] = (kw, _jax_train(m, p, x, y, 1200), x, y)

    arrays = jsynthetic(num_frames=4, num_points=8, image_size=HW, seed=7)
    kw = dict(model_type="MODEL_18_POINTS_PER_WING_VIT", patch_size=16, projection_dim=64,
              transformer_layers=2, num_heads=4, dropout_ratio=0.0, compute_dtype="float32")
    cfg = JConfig(**kw)
    ds, _ = jbuild_dataset(cfg, arrays)
    x = ds.data["box"][:8].astype(jnp.float32)
    y = ds.data["confmaps"][:8].astype(jnp.float32)
    m = jbuild_model(cfg, x.shape[1:], y.shape[-1])
    p = m.init({"params": jax.random.key(0)}, x, train=False)["params"]
    out["vit"] = (kw, _jax_train(m, p, x, y, 600), x, y)

    rng = np.random.default_rng(11)
    kw = dict(model_type="ALL_CAMS_18_POINTS", num_base_filters=8, num_blocks=2,
              dropout_ratio=0.0, compute_dtype="float32")
    cfg = JConfig(**kw)
    x = jnp.asarray(rng.random((6, HW, HW, 16), np.float32))
    pk = jnp.asarray(rng.uniform(8, 40, (6, 4 * 8, 2)).astype(np.float32))
    y = jconfmaps(pk, (HW, HW), 3.0)
    m = jbuild_model(cfg, x.shape[1:], 4 * 8)
    p = m.init({"params": jax.random.key(1)}, x, train=False)["params"]
    out["multicam"] = (kw, _jax_train(m, p, x, y, 150), x, y)
    return out


@pytest.mark.parametrize("name", ["basicnet", "vit", "multicam"])
def test_generic_quantized_peak_parity(trained, name):
    """JAX's test_generic_quantized_matches_basicnet, _vit_peak_parity and
    _multicam_peak_parity in the port: the int8 forward's decoded peaks
    against the float forward's, median distance <= 1 px; for the ViT the
    int8 model's pixel L2 to the targets within 1.5 px of the float
    model's."""
    kw, jparams, x, y = trained[name]
    cfg = Config(**kw)
    x, y = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y))
    model = build_model(cfg, tuple(x.shape[1:]), y.shape[-1]).eval()
    sd = {n: v.float() for n, v in weights.flax_to_state_dict(_bridge(jparams), model).items()}
    model.load_state_dict(sd)
    scales = tq.calibrate_apply(model, sd, [(x,)])
    if name == "vit":  # patch conv, 2 x (qkv, out, fc1, fc2), 4 deconvs
        assert len(scales) == 1 + 2 * 4 + 4, sorted(scales)
    q_maps = tq.make_quantized_apply(model, sd, scales)(x)
    with torch.no_grad():
        ref_maps = functional_call(model, sd, (x,))
    d = np.linalg.norm((tpeaks.find_peaks(ref_maps) - tpeaks.find_peaks(q_maps)).numpy(),
                       axis=-1)
    assert np.median(d) <= PEAK_MEDIAN_PX, np.median(d)
    if name == "vit":
        l2_ref = np.median(tpeaks.l2_distances(ref_maps, y).numpy())
        l2_q = np.median(tpeaks.l2_distances(q_maps, y).numpy())
        assert l2_q <= l2_ref + 1.5, (l2_q, l2_ref)


# ---------------------------------------------------------------------------
# the Predictor's routes (tests/test_serving_dispatch.py)
# ---------------------------------------------------------------------------
def _predictor_case(model_type, overrides, cin, k):
    cfg = Config(model_type=model_type, num_base_filters=8, **overrides)
    with torch.device("meta"):
        model = build_model(cfg, (HW, HW, cin), k)
    state = loop.create_train_state(model, cfg, seed=0, device="cpu")
    frames = np.random.default_rng(0).random((4, HW, HW, cin)).astype(np.float32)
    return cfg, weights.state_dict_to_flax(state.params, model), frames


def _check_points(pts, n, k):
    assert pts.shape == (n, 3, k), pts.shape
    assert np.isfinite(pts).all()
    assert ((pts[:, :2] >= 0) & (pts[:, :2] < HW)).all()


def test_tf_flavor_flagship_never_takes_resident_path():
    """The hand-scheduled int8 forward is the torch decoder's; a tf-flavour
    BasicNet serves on "int8_generic"."""
    cfg, params, frames = _predictor_case(C.MODEL_18_POINTS_PER_WING, {"arch_flavor": "tf"},
                                          4, 6)
    pred = tinfer.Predictor(cfg, params, frames.shape[1:], 6, device="cpu", chunk_size=4,
                            use_quantized=True, calibration_frames=frames)
    assert pred.serving_path == "int8_generic"
    _check_points(pred(frames), 4, 6)


def test_vit_conv_only_mixed_precision_route():
    """'conv_only' on a ViT: "int8_generic" with the decoder's deconvs on
    int8 and the trunk in bf16; the contract holds; an unknown mode raises."""
    overrides = {"projection_dim": 24, "num_heads": 2, "transformer_layers": 1,
                 "patch_size": 16}
    cfg, params, frames = _predictor_case(C.MODEL_18_POINTS_PER_WING_VIT, overrides, 4, 6)
    pred = tinfer.Predictor(cfg, params, frames.shape[1:], 6, device="cpu", chunk_size=4,
                            use_quantized=True, calibration_frames=frames,
                            quantized_layers="conv_only", use_fused=True)
    assert pred.serving_path == "int8_generic"
    _check_points(pred(frames), 4, 6)
    with pytest.raises(ValueError, match="quantized_layers"):
        tinfer.Predictor(cfg, params, frames.shape[1:], 6, device="cpu",
                         use_quantized=True, calibration_frames=frames,
                         quantized_layers="dense_only")
