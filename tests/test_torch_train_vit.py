"""ViT training in the port against JAX (CPU, 48 px, dim 32, depth 1): one
train step of ``ViTPoseNet`` and ``ViT4Cameras`` against JAX's
``make_train_step`` at accumulation 1 and 2 (float32, dropout 0,
augmentation off, targets rendered from the peaks; the setup and tolerances
of tests/test_torch_train_zoo.py::test_train_step_matches_jax), the tf
flavour's gradients, its live 0.1 attention dropout, flax's initialiser
law, the ``Trainer`` on all seven ViT types (tests/test_vit_training.py),
a bit-for-bit resume, and the run directory served on "module" and
"fused".

JAX's train step always draws the tf flavour's fixed 0.1 attention dropout,
so that flavour's gradients are held against ``jax.value_and_grad`` of
``model.apply(..., train=False)`` built here, with the port module's
attention-dropout rate set to 0 on the instance."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch import viz, weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.data.synthetic import make_synthetic_arrays
from pose_estimation_amitai_torch.models import _VIT_4CAM, _VIT_SINGLE, build_model
from pose_estimation_amitai_torch.models import vit as tvit
from pose_estimation_amitai_torch.train import loop
from pose_estimation_amitai_torch.train.trainer import Trainer
from pose_estimation_amitai_tpu.config import Config as JConfig
from pose_estimation_amitai_tpu.models import build_model as jbuild_model
from pose_estimation_amitai_tpu.ops.gaussian import confmaps_from_peaks as jconfmaps
from pose_estimation_amitai_tpu.train import loop as jloop

from test_torch_resnet import one_thread  # noqa: F401 (a fixture)

# the zoo step test's tolerances (tests/test_torch_train_zoo.py)
GRAD_RTOL = 1e-4  # of each gradient tensor's largest element
PARAM_ATOL = 1e-6  # updated parameters, beyond what the gradients' difference explains
ADAM_EPS = 1e-8
LR_SCALE = 0.5
LOSS_RTOL = 1e-5  # the port's loss against the float64 MSE of flax's maps
JAX_MEAN_RTOL = 5e-5  # JAX's float32 mean against the same
ZERO_GRAD = 1e-12  # absolute floor of the gradient tolerance
B1 = 0.9  # Adam's first-moment decay: after one step mu = (1 - B1) g
DROPOUT_KEEP_ATOL = 0.01  # the kept share of 0.1-dropped probabilities

VIT = dict(patch_size=16, projection_dim=32, transformer_layers=1, num_heads=2,
           fully_connected_expand=2, dim_head=0)
# (model_type, in_channels, maps)
FAMILIES = {"single": (C.MODEL_18_POINTS_PER_WING_VIT, 4, 6),
            "four": (C.ALL_CAMS_18_POINTS_VIT, 16, 12)}


@pytest.fixture(autouse=True)
def _one_thread_here(one_thread):
    """Every case of this file on one intra-op thread (test_torch_resnet.py
    ``one_thread``: workers of the parallel run share the cores)."""


@pytest.fixture
def no_pngs(monkeypatch):
    monkeypatch.setattr(viz, "available", lambda: False)


def _data(cin, k, seed=0, n=8):
    rng = np.random.default_rng(seed)
    return {"box": rng.random((n, 48, 48, cin), np.float32),
            "peaks": rng.uniform(4, 44, (n, k, 2)).astype(np.float32),
            "peak_vals": rng.uniform(0.5, 1.0, (n, k)).astype(np.float32)}


def _target(jcfg, data, ids):
    return np.asarray(jconfmaps(jnp.asarray(data["peaks"][ids]), (48, 48), jcfg.sigma),
                      np.float64) * data["peak_vals"][ids][:, None, None, :]


def _setup(which, flavor="torch", accum=1):
    mt, cin, k = FAMILIES[which]
    kw = dict(model_type=mt, arch_flavor=flavor, compute_dtype="float32", dropout_ratio=0.0,
              do_augmentations=False, accumulation_steps=accum, **VIT)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    model = build_model(cfg, (48, 48, cin), k)
    state0 = loop.create_train_state(model, cfg, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(2)
    # biases and LayerNorm parameters drawn, so every bridge path is seen
    params = {n: v + 0.05 * torch.randn(v.shape, generator=gen) if v.dim() == 1 else v
              for n, v in state0.params.items()}
    return cfg, jcfg, model, state0.replace(params=params), _data(cin, k)


@pytest.mark.parametrize("which, accum", [("single", 1), ("single", 2), ("four", 1),
                                          ("four", 2)])
def test_vit_train_step_matches_jax(which, accum):
    """Loss, gradients and the Adam-updated parameters after one step.
    ``ViTPoseNet``'s gradients within GRAD_RTOL of each tensor's largest.
    ``ViT4Cameras``' fusion-block LayerNorm scales have gradients in which
    most of the sum cancels (their largest is 0.5% of the model's): the
    port's float32 ones lie 1.9e-4 of their own largest from the same step
    in float64, JAX's 2e-6, and every tensor of either within 2e-5 of the
    model's largest gradient. So that model's gradients are held within
    GRAD_RTOL of the model's largest gradient, against JAX's and against
    the port's float64 step."""
    cfg, jcfg, model, state, data = _setup(which, accum=accum)
    mt, cin, k = FAMILIES[which]
    params = state.params
    idx = np.asarray([[3, 1, 6, 4], [0, 7, 2, 5]][:accum], np.int32)
    jmodel = jbuild_model(jcfg, (48, 48, cin), k)
    tree = jax.tree_util.tree_map(jnp.asarray, weights.state_dict_to_flax(params, model))
    jstate = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=tree,
                              opt_state=jloop.create_optimizer(jcfg).init(tree),
                              batch_stats={}, rng=jax.random.key(0))
    jnew, jl = jloop.make_train_step(jmodel, jcfg)(
        jstate, {n: jnp.asarray(v) for n, v in data.items()}, jnp.asarray(idx), LR_SCALE)
    tdata = {n: torch.from_numpy(v) for n, v in data.items()}
    new, loss = loop.make_train_step(model, cfg)(state, tdata, idx, LR_SCALE)

    apply = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, train=False))
    mse = np.mean([np.mean(np.square(np.asarray(apply(tree, jnp.asarray(data["box"][i])),
                                                np.float64) - _target(jcfg, data, i)))
                   for i in idx])
    np.testing.assert_allclose(float(loss), mse, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(jl), mse, rtol=JAX_MEAN_RTOL)

    def mean_grads(m, params, data):
        fn = loop.make_grad_fn(m, cfg)
        parts = [fn(params, data, i, torch.Generator()) for i in idx]
        return {n: (sum(g[n] for _, g in parts) / accum).double().numpy() for n in params}

    grads = mean_grads(model, params, tdata)
    jgrads = weights.flax_to_state_dict(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1 - B1), jnew.opt_state[0].mu), model)
    want_params = weights.flax_to_state_dict(jnew.params, model)
    assert set(grads) == set(jgrads) == set(new.params)
    if which == "four":
        cls = tvit.ViT4Cameras
        exact = mean_grads(
            cls(cin, 48, k, patch_size=16, dim=32, depth=1, heads=2, dim_head=64,
                mlp_expand=2, dtype=torch.float64),
            {n: v.double() for n, v in params.items()},
            {n: v.double() for n, v in tdata.items()})
        top = max(np.abs(g).max() for g in exact.values())
    for name, p in new.params.items():
        g, jg = grads[name], jgrads[name].numpy()
        if which == "four":
            tol = GRAD_RTOL * top
            np.testing.assert_allclose(g, exact[name], atol=tol, rtol=0, err_msg=name)
        else:
            tol = GRAD_RTOL * np.abs(jg).max() + ZERO_GRAD
        np.testing.assert_allclose(g, jg, atol=tol, rtol=0, err_msg=name)
        same = np.sign(g) == np.sign(jg)
        assert np.abs(jg[~same]).max(initial=0.0) <= tol, name
        explained = cfg.learning_rate * LR_SCALE * ADAM_EPS * np.abs(g - jg) / (
            (np.abs(g) + ADAM_EPS) * (np.abs(jg) + ADAM_EPS))
        d = np.abs(p.numpy() - want_params[name].numpy()) - explained
        assert d[same].max(initial=0.0) <= PARAM_ATOL, (name, d[same].max())


def test_tf_vit_gradients_match_jax():
    """tf flavour (post-LN, biased qkv, relu MLP, channel-halving decoder):
    with the attention dropout off on the port's instances, the loss and
    gradients of one microbatch equal ``jax.value_and_grad`` of flax's
    eval forward on the same parameters."""
    cfg, jcfg, model, state, data = _setup("single", "tf")
    mt, cin, k = FAMILIES["single"]
    attns = [m for m in model.modules() if isinstance(m, tvit.Attention)]
    assert attns and all(m.dropout == tvit.TF_ATTENTION_DROPOUT for m in attns)
    for m in attns:
        m.dropout = 0.0
    ids = np.asarray([3, 1, 6, 4])
    tdata = {n: torch.from_numpy(v) for n, v in data.items()}
    loss, grads = loop.make_grad_fn(model, cfg)(state.params, tdata, ids, torch.Generator())

    jmodel = jbuild_model(jcfg, (48, 48, cin), k)
    tree = jax.tree_util.tree_map(jnp.asarray, weights.state_dict_to_flax(state.params, model))
    x, y = jnp.asarray(data["box"][ids]), jnp.asarray(_target(jcfg, data, ids), jnp.float32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jnp.mean(jnp.square(
        jmodel.apply({"params": p}, x, train=False) - y))))(tree)
    np.testing.assert_allclose(float(loss), float(jl), rtol=JAX_MEAN_RTOL)
    jgrads = weights.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jg), model)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        want = jgrads[name].numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=0, err_msg=name,
                                   atol=GRAD_RTOL * np.abs(want).max() + ZERO_GRAD)


def test_tf_attention_dropout_keeps_nine_tenths(monkeypatch):
    """The tf flavour's fixed 0.1 dropout on the attention probabilities is
    live in training: 0.9 of them kept (each scaled by 1 / 0.9), drawn from
    the generator; none in eval."""
    seen = []
    real = tvit.drop

    def spy(x, rate, generator):
        out = real(x, rate, generator)
        seen.append((rate, x, out))
        return out

    monkeypatch.setattr(tvit, "drop", spy)
    net = tvit.ViTPoseNet(4, 48, 6, dim=32, depth=2, heads=2, dim_head=32, flavor="tf",
                          dtype=torch.float32)
    x = torch.rand((8, 48, 48, 4), generator=torch.Generator().manual_seed(0))
    net(x, torch.Generator().manual_seed(1))
    probs = [(x, out) for rate, x, out in seen if rate == tvit.TF_ATTENTION_DROPOUT]
    assert len(probs) == 2  # one per block
    kept = torch.cat([(out != 0).flatten() for _, out in probs]).float().mean()
    assert abs(float(kept) - 0.9) <= DROPOUT_KEEP_ATOL, float(kept)
    for xin, out in probs:
        live = out != 0
        torch.testing.assert_close(out[live], xin[live] / 0.9)
    seen.clear()
    net.eval()
    net(x, torch.Generator().manual_seed(1))
    assert all(rate == 0.0 for rate, _, _ in seen)


@pytest.mark.parametrize("flavor", ["torch", "tf"])
def test_vit_init_follows_flax_law(flavor):
    """lecun-normal over each fan-in (a Linear's input features, the patch
    conv's C * p * p, a transposed conv's input channels x taps), truncated
    at 2 sigma / 0.8796; LayerNorm scales one and biases zero; the
    positional embedding a unit normal; no qkv bias in the torch flavour."""
    cfg = Config(model_type=C.MODEL_18_POINTS_PER_WING_VIT, arch_flavor=flavor,
                 patch_size=16, projection_dim=64, transformer_layers=1, num_heads=2,
                 fully_connected_expand=2, dim_head=1)
    with torch.device("meta"):
        model = build_model(cfg, (48, 48, 4), 6)
    params = loop.create_train_state(model, cfg, seed=0, device="cpu").params
    assert list(params) == [n for n, _ in model.named_parameters()]
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in params.values())
    fans = {"patch_embed.proj.weight": 4 * 16 * 16,
            "transformer.attn0.to_qkv.weight": 64, "transformer.attn0.to_out.weight": 128,
            "transformer.ff0.fc1.weight": 64, "transformer.ff0.fc2.weight": 128,
            "decoder.deconv1.weight": 64 * 9}
    for name, fan in fans.items():
        w = params[name]
        assert abs(float(w.std()) * fan ** 0.5 - 1.0) < 0.05, name
        assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / fan ** 0.5 + 1e-6, name
    assert params["transformer.attn0.to_qkv.weight"].shape == (3 * 128, 64)  # (out, in)
    pos = params["patch_embed.pos_embedding"]
    assert pos.shape == (1, 9, 64) and abs(float(pos.std()) - 1.0) < 0.1
    assert float(pos.abs().max()) > 2.5  # a plain normal, not truncated
    norms = [n for n, m in model.named_modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == (2 if flavor == "tf" else 4)
    for n in norms:
        assert torch.equal(params[f"{n}.weight"], torch.ones(64))
        assert torch.equal(params[f"{n}.bias"], torch.zeros(64))
    assert ("transformer.attn0.to_qkv.bias" in params) == (flavor == "tf")
    assert all(not v.any() for n, v in params.items() if n.endswith("bias"))


def test_vit_trainer_resume_is_bit_for_bit(tmp_path, no_pngs):
    """3 epochs through a checkpoint after 2 equal 3 in one go: the tf
    flavour, its 0.1 attention dropout live, augmentation on,
    accumulation 2."""
    arrays = make_synthetic_arrays(num_frames=6, num_points=8, image_size=48, seed=0)
    cfg = Config(model_type=C.MODEL_18_POINTS_PER_WING_VIT, arch_flavor="tf", epochs=3,
                 batch_size=2, batches_per_epoch=2, accumulation_steps=2,
                 rotation_range=10.0, xy_shifts=2.0, val_fraction=0.5, seed=0,
                 compute_dtype="float32", **VIT)
    whole = Trainer(cfg.replace(base_output_path=str(tmp_path / "a")), arrays=arrays,
                    device="cpu")
    whole.train()
    part = Trainer(cfg.replace(epochs=2, base_output_path=str(tmp_path / "b")), arrays=arrays,
                   device="cpu")
    part.train()
    resumed = Trainer(cfg.replace(base_output_path=str(tmp_path / "c"),
                                  resume_from=part.run_path), arrays=arrays, device="cpu")
    assert resumed.start_epoch == 2
    resumed.train()
    assert resumed.state.step == whole.state.step == 3
    for name, want in whole.state.params.items():
        assert torch.equal(resumed.state.params[name], want), name


@pytest.mark.parametrize("mt, flavor", [(mt, f) for mt in sorted(_VIT_SINGLE)
                                        for f in ("torch", "tf")]
                         + [(mt, "torch") for mt in sorted(_VIT_4CAM)])
def test_vit_training_smoke(tmp_path, no_pngs, mt, flavor):
    """tests/test_vit_training.py on every ViT type: one epoch of the
    ``Trainer`` (bf16 compute) gives finite losses. The 4-camera types
    augment each view on its own transform; the ``*_TO_POINTS`` type trains
    on the pointwise loss."""
    four = mt in _VIT_4CAM
    arrays = make_synthetic_arrays(num_frames=4, num_points=8, image_size=48)
    cfg = Config(model_type=mt, arch_flavor=flavor, epochs=1, batch_size=4,
                 batches_per_epoch=1, base_output_path=str(tmp_path),
                 do_augmentations=four, rotation_range=10.0, val_fraction=0.5, seed=0,
                 **VIT)
    trainer = Trainer(cfg, arrays=arrays, device="cpu")
    assert isinstance(trainer.model, tvit.ViT4Cameras if four else tvit.ViTPoseNet)
    history = trainer.train()
    assert np.isfinite(history["train_loss"][0])
    assert np.isfinite(history["val_loss"][0])
    if mt == C.MODEL_18_POINTS_PER_WING_VIT_TO_POINTS:
        assert history["val_loss"][0] > 1.0  # squared pixels, not map values


@pytest.mark.parametrize("which", ["single", "four"])
def test_vit_run_directory_serves_on_module_and_fused(tmp_path, no_pngs, which):
    """A ViT run directory through ``Predictor.from_checkpoint``: the
    "fused" route (the attention kernel's plain version on the CPU) gives
    the "module" route's maps and peaks, and both the maps of the trained
    parameters' eval forward."""
    from pose_estimation_amitai_torch.infer import Predictor

    mt, cin, _ = FAMILIES[which]
    arrays = make_synthetic_arrays(num_frames=4, num_points=8, image_size=48)
    cfg = Config(model_type=mt, epochs=1, batch_size=4, batches_per_epoch=2,
                 base_output_path=str(tmp_path), do_augmentations=False,
                 val_fraction=0.5, seed=0, compute_dtype="float32", **VIT)
    trainer = Trainer(cfg, arrays=arrays, device="cpu")
    trainer.train()
    assert os.path.exists(os.path.join(trainer.run_path, "best_model.pt"))
    ds = trainer.dataset
    batch = ds.gather(np.arange(ds.num_samples))
    box, k = batch["image"].numpy(), batch["confmaps"].shape[-1]
    assert box.shape[1:] == (48, 48, cin)
    out = {}
    for fused in (False, True):
        pred = Predictor.from_checkpoint(cfg, trainer.run_path, box.shape[1:], k,
                                         device="cpu", chunk_size=3, use_fused=fused,
                                         return_heatmaps=True)
        assert pred.serving_path == ("fused" if fused else "module")
        out[fused] = pred(box)
    np.testing.assert_allclose(out[True][0], out[False][0], atol=1e-5)
    np.testing.assert_array_equal(out[True][1][:, :2], out[False][1][:, :2])
    from pose_estimation_amitai_torch.train import checkpoint as ckpt

    served = ckpt.load_params(os.path.join(trainer.run_path, "best_model.pt"))
    want = loop.make_predict_fn(trainer.model)(served, torch.from_numpy(box)).numpy()
    np.testing.assert_allclose(out[False][0], want, atol=1e-5)
