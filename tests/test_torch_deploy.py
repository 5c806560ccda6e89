"""The port's serving artifact (deploy.py) against its Predictor and the JAX
package's artifact, and the kernels' custom ops (ops/custom_ops.py).

Every route the port's Predictor serves is exported here on the CPU: the
fused ones run the ops' plain versions there, and their exported graphs must
name the custom ops, so the kernel is not traced away into its plain
decomposition. ``torch.library.opcheck`` holds each op's schema, fake
implementation and dispatch.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_estimation_amitai_torch import cli, weights
from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.deploy import MAGIC, export_predictor, load_exported
from pose_estimation_amitai_torch.infer import Predictor
from pose_estimation_amitai_torch.ops import custom_ops
from pose_estimation_amitai_torch.train import checkpoint
from pose_estimation_amitai_tpu.config import Config as JConfig
from pose_estimation_amitai_tpu.deploy import export_predictor as jexport
from pose_estimation_amitai_tpu.deploy import load_exported as jload
from pose_estimation_amitai_tpu.infer import Predictor as JPredictor

from test_torch_resnet import one_thread  # noqa: F401 (a fixture)

HW, IN_CH, OUT_CH, CHUNK = 48, 4, 6, 4
VIT_HW = 32
F32_ATOL = 1e-5  # a float route's loaded program vs its Predictor (JAX's test)
INT8_ATOL = 1e-4  # an int8 route's (JAX's test)


@pytest.fixture(autouse=True)
def _one_thread_here(one_thread):
    """Every case on one intra-op thread (workers of the parallel run share
    the cores)."""


@pytest.fixture(scope="module")
def params():
    return weights.init_basicnet_params(np.random.default_rng(0), IN_CH, OUT_CH, filters=8)


def _frames(n, hw=HW, seed=1):
    return np.random.default_rng(seed).random((n, hw, hw, IN_CH), dtype=np.float32)


CFG = Config(num_base_filters=8, compute_dtype="float32", dropout_ratio=0.0)
VIT_CFG = Config(model_type=C.MODEL_18_POINTS_PER_WING_VIT, compute_dtype="float32",
                 patch_size=8, projection_dim=32, transformer_layers=2, num_heads=2,
                 dim_head=False)
# route -> (config, Predictor keywords, tolerance, custom ops its graph names)
ROUTES = {
    "module": (CFG, {}, F32_ATOL, set()),
    "fused": (CFG, {"use_fused": True}, F32_ATOL,
              {"fused_encoder_stage", "fused_decoder"}),
    "int8_resident": (CFG, {"use_quantized": True}, INT8_ATOL, set()),
    "int8_fused": (CFG, {"use_quantized": True, "use_fused": True}, INT8_ATOL,
                   {"fused_quantized_stage"}),
    "int8_generic": (CFG.replace(dilation_rate=1), {"use_quantized": True}, INT8_ATOL, set()),
    "vit_fused": (VIT_CFG, {"use_fused": True}, F32_ATOL, {"fused_attention"}),
    "vit_module": (VIT_CFG, {}, F32_ATOL, set()),
}


def _predictor(route, params, **kw):
    cfg, rkw, _, _ = ROUTES[route]
    vit = route.startswith("vit")
    hw = VIT_HW if vit else HW
    p = (weights.init_vit_params(np.random.default_rng(0), IN_CH, OUT_CH, VIT_HW,
                                 patch_size=8, dim=32, depth=2, heads=2, dim_head=64)
         if vit else params)
    if rkw.get("use_quantized"):
        rkw = {**rkw, "calibration_frames": _frames(8, hw, seed=2)}
    return Predictor(cfg, p, (hw, hw, IN_CH), OUT_CH, device="cpu", chunk_size=CHUNK,
                     **rkw, **kw), hw


def _graph_ops(loaded) -> set:
    return {str(n.target).split(".")[1] for n in loaded.module.graph.nodes
            if str(n.target).startswith(custom_ops.NAMESPACE + ".")}


@pytest.mark.parametrize("route", list(ROUTES))
def test_every_route_round_trips(tmp_path, params, route):
    """Each route exported on the CPU, loaded, and served over a movie with a
    padded tail: the Predictor's peaks; the fused graphs name their ops."""
    pred, hw = _predictor(route, params, decode="refined")
    want_path = {"vit_fused": "fused", "vit_module": "module"}.get(route, route)
    assert pred.serving_path == want_path
    path = str(tmp_path / "m.ptexp")
    header = export_predictor(pred, path)
    assert header["serving_path"] == want_path and header["device_type"] == "cpu"
    assert header["chunk_size"] == CHUNK and header["image_shape"] == [hw, hw, IN_CH]
    loaded = load_exported(path, "cpu")
    frames = _frames(2 * CHUNK + 3, hw)
    got, want = loaded(frames), pred(frames)
    assert got.shape == want.shape == (2 * CHUNK + 3, 3, OUT_CH)
    np.testing.assert_allclose(got, want, rtol=0, atol=ROUTES[route][2])
    assert _graph_ops(loaded) == ROUTES[route][3]
    assert loaded(frames[:0]).shape == (0, 3, OUT_CH)


def test_refusals(tmp_path, params):
    """Bad magic, the JAX package's artifact (its magic), another device
    type, return_heatmaps, the camera-matrix family."""
    junk = str(tmp_path / "junk.ptexp")
    with open(junk, "wb") as f:
        f.write(b"NOTANEXPORT")
    with pytest.raises(ValueError, match="not an exported-predictor"):
        load_exported(junk, "cpu")

    jcfg = JConfig(num_base_filters=8, dropout_ratio=0.0)
    jpath = str(tmp_path / "jax.pexp")
    jexport(JPredictor(jcfg, jax.tree_util.tree_map(jnp.asarray, params), (HW, HW, IN_CH),
                       OUT_CH, chunk_size=CHUNK), jpath)
    with pytest.raises(ValueError, match="PEATPU01"):
        load_exported(jpath, "cpu")

    pred, _ = _predictor("module", params)
    path = str(tmp_path / "m.ptexp")
    export_predictor(pred, path)
    with open(path, "rb") as f:
        assert f.read(len(MAGIC)) == MAGIC
    with pytest.raises(ValueError, match="device type only"):
        load_exported(path, "cuda")

    with pytest.raises(ValueError, match="return_heatmaps"):
        export_predictor(_predictor("module", params, return_heatmaps=True)[0], path)

    cfg = Config(model_type=C.ALL_CAMS_DISENTANGLED_PER_WING_CNN, num_base_filters=8,
                 dropout_ratio=0.0)
    with torch.device("meta"):
        from pose_estimation_amitai_torch.models import build_model

        model = build_model(cfg, (HW, HW, 16), OUT_CH * 4)
    from pose_estimation_amitai_torch.train.loop import _init_params, init_batch_stats

    sd = _init_params(model, 0)
    cams = (np.zeros((4, 4, 3, 4), np.float32), np.zeros((4, 4, 4, 3), np.float32))
    cam_pred = Predictor(cfg, weights.state_dict_to_flax(sd, model), (HW, HW, 16), OUT_CH * 4,
                         device="cpu", chunk_size=CHUNK, cameras=cams,
                         batch_stats=weights.batch_stats_to_flax(init_batch_stats(model, "cpu")))
    with pytest.raises(ValueError, match="camera matrices"):
        export_predictor(cam_pred, path)


def test_loaded_module_program_matches_jax_artifact(tmp_path, params):
    """The port's loaded module program against JAX's loaded artifact on the
    same weights, refined decode."""
    jcfg = JConfig(num_base_filters=8, dropout_ratio=0.0, compute_dtype="float32")
    jpath = str(tmp_path / "jax.pexp")
    jexport(JPredictor(jcfg, jax.tree_util.tree_map(jnp.asarray, params), (HW, HW, IN_CH),
                       OUT_CH, chunk_size=CHUNK, decode="refined"), jpath)
    pred, _ = _predictor("module", params, decode="refined")
    path = str(tmp_path / "m.ptexp")
    export_predictor(pred, path)
    frames = _frames(CHUNK + 1)
    np.testing.assert_allclose(load_exported(path, "cpu")(frames), jload(jpath)(frames),
                               rtol=0, atol=1e-4)


def test_cli_export(tmp_path, params):
    ckpt = str(tmp_path / "weights.pt")
    with torch.device("meta"):
        from pose_estimation_amitai_torch.models import build_model

        model = build_model(CFG, (HW, HW, IN_CH), OUT_CH)
    checkpoint.save_params(ckpt, weights.flax_to_state_dict(params, model))
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump({"number of base filters": 8, "dropout ratio": 0.0,
                   "compute_dtype": "float32"}, f)
    out = str(tmp_path / "m.ptexp")
    assert cli.main(["export", cfg_path, ckpt, out, "--chunk-size", str(CHUNK),
                     "--image-shape", str(HW), str(HW), str(IN_CH),
                     "--out-channels", str(OUT_CH), "--device", "cpu"]) == 0
    loaded = load_exported(out, "cpu")
    frames = _frames(3)
    pred, _ = _predictor("module", params)
    np.testing.assert_allclose(loaded(frames), pred(frames), rtol=0, atol=F32_ATOL)
    out8 = str(tmp_path / "m8.ptexp")
    assert cli.main(["export", cfg_path, ckpt, out8, "--chunk-size", str(CHUNK),
                     "--image-shape", str(HW), str(HW), str(IN_CH),
                     "--out-channels", str(OUT_CH), "--quantized", "--device", "cpu"]) == 0
    assert load_exported(out8, "cpu").header["serving_path"] == "int8_resident"


# ---------------------------------------------------------------------------
# the custom ops
# ---------------------------------------------------------------------------
def _op_samples():
    g = torch.Generator().manual_seed(0)

    def r(*s, dtype=torch.float32):
        return torch.rand(*s, generator=g).to(dtype)

    x = r(2, 8, 8, 4)
    w1, w2, b = r(3, 3, 4, 8) - 0.5, r(3, 3, 8, 8) - 0.5, r(8)
    lat = r(1, 4, 4, 8)
    q = (r(2, 8, 8, 4) * 60).round().to(torch.int8)
    qw1 = (r(3, 3, 4, 8) * 200 - 100).round().to(torch.int8)
    qw2 = (r(3, 3, 8, 8) * 200 - 100).round().to(torch.int8)
    m = r(8) * 1e-3
    return [
        (custom_ops.fused_encoder_stage, (x, w1, b, w2, b, w2, b, 2, 0.1, True)),
        (custom_ops.fused_encoder_stage, (x, w1, b, w2, b, w2, b, 1, 0.1, False)),
        (custom_ops.fused_decoder, (lat, w2, b, w2, b, w2, b, r(3, 3, 8, 5), r(5), 0.1)),
        (custom_ops.fused_quantized_stage,
         (q, qw1, m, b, qw2, m, b, qw2, m, b, 30.0, 30.0, 30.0, 2, 0.1, True)),
        (custom_ops.fused_attention, (r(2, 5, 3, 2, 8),)),
        (custom_ops.fused_attention, (r(2, 5, 3, 2, 16, dtype=torch.bfloat16),)),
    ]


@pytest.mark.parametrize("i", range(6))
def test_opcheck(i):
    op, args = _op_samples()[i]
    torch.library.opcheck(op, args)


def test_ops_equal_their_wrappers():
    """On CPU tensors each op is its wrapper's plain version, exactly."""
    from pose_estimation_amitai_torch.ops import hopper_attention, hopper_conv
    from pose_estimation_amitai_torch.ops import hopper_deconv, hopper_qconv

    samples = _op_samples()
    x, w1, b1, w2, b2, w3, b3, dil, alpha, pool = samples[0][1]
    assert torch.equal(samples[0][0](*samples[0][1]), hopper_conv.fused_encoder_stage(
        x, w1, b1, w2, b2, w3, b3, dilation=dil, alpha=alpha, pool=pool))
    lat, *ws, alpha = samples[2][1]
    assert torch.equal(samples[2][0](*samples[2][1]),
                       hopper_deconv.fused_decoder(lat, *ws, alpha=alpha))
    q, *rest = samples[3][1]
    ws, (i2, i3, io, dil, alpha, pool) = rest[:9], rest[9:]
    assert torch.equal(samples[3][0](*samples[3][1]), hopper_qconv.fused_quantized_stage(
        q, *ws, i2, i3, io, dilation=dil, alpha=alpha, pool=pool))
    (qkv,) = samples[4][1]
    want = hopper_attention.fused_attention(*(qkv[:, :, j].permute(0, 2, 1, 3) for j in range(3)))
    assert torch.equal(samples[4][0](qkv), want.permute(0, 2, 1, 3))


def test_artifact_is_small_and_self_describing(tmp_path, params):
    pred, _ = _predictor("fused", params)
    path = str(tmp_path / "m.ptexp")
    header = export_predictor(pred, path)
    assert os.path.getsize(path) < 4 * 1024 * 1024
    assert header["format"] == "pose-estimation-amitai-torch/exported-predictor"
    assert header["out_shape"] == [CHUNK, 3, OUT_CH]
    assert load_exported(path, "cpu").header == header
