"""The port's training layer against the JAX package (CPU, filters 8,
(48, 48, 4) frames): one train step against JAX's ``make_train_step`` in
float32 with dropout 0 and no augmentation (targets re-rendered from the
peaks) at accumulation 1 and 2 -- loss, gradients and the Adam-updated
parameters; the eval step; the plateau scheduler; the state_dict bridge
both ways through flax ``BasicNet.apply``; and what has no JAX counterpart
to equal: the dropout, the seeded draws, and resume from a checkpoint bit
for bit with augmentation and dropout on."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch import weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.data import build_dataset, make_synthetic_arrays
from pose_estimation_amitai_torch.models import BasicNet, build_model
from pose_estimation_amitai_torch.models.layers import drop
from pose_estimation_amitai_torch.train import checkpoint, loop
from pose_estimation_amitai_tpu.config import Config as JConfig
from pose_estimation_amitai_tpu.models import build_model as jbuild_model
from pose_estimation_amitai_tpu.ops.gaussian import confmaps_from_peaks as jconfmaps
from pose_estimation_amitai_tpu.train import loop as jloop

from test_torch_resnet import one_thread  # noqa: F401 (a fixture)

K = 6
# float32 on the CPU, sums in another order: gradients within this share of
# each tensor's largest one; updated parameters within this (Adam moves each
# by about lr = 1e-3 in the first step)
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-6
LOSS_RTOL = 1e-5


def _data(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return {"box": rng.random((n, 48, 48, 4), np.float32),
            "peaks": rng.uniform(4, 44, (n, K, 2)).astype(np.float32),
            "peak_vals": rng.uniform(0.5, 1.0, (n, K)).astype(np.float32)}


def _setup(accum, seed=0):
    kw = dict(num_base_filters=8, compute_dtype="float32", dropout_ratio=0.0,
              do_augmentations=False, accumulation_steps=accum)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    data = _data(seed)
    jmodel = jbuild_model(jcfg, (48, 48, 4), K)
    jstate = jloop.create_train_state(jmodel, jcfg, {"image": jnp.asarray(data["box"][:2])},
                                      seed=seed)
    model = build_model(cfg, (48, 48, 4), K)
    params = weights.basicnet_state_dict(jstate.params)
    state = loop.TrainState(step=0, params=params, seed=seed,
                            opt_state=loop.create_optimizer(cfg, list(params.values())).state_dict())
    return cfg, jcfg, data, jmodel, jstate, model, state


def _jax_grads(jmodel, jcfg, params, data, idx):
    """JAX's mean microbatch loss and gradients, as its step forms them."""
    jd = {k: jnp.asarray(v) for k, v in data.items()}

    def loss(p, ids):
        maps = jconfmaps(jd["peaks"][ids], (48, 48), jcfg.sigma) * jd["peak_vals"][ids][:, None, None, :]
        pred = jmodel.apply({"params": p}, jd["box"][ids], train=True,
                            rngs={"dropout": jax.random.key(0)})
        return jnp.mean(jnp.square(pred - maps))

    vals, grads = zip(*[jax.jit(jax.value_and_grad(loss))(params, jnp.asarray(i))
                        for i in idx])
    g = jax.tree_util.tree_map(lambda *x: sum(x) / len(x), *grads)
    return float(sum(vals) / len(vals)), weights.basicnet_state_dict(g)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    cfg, jcfg, data, jmodel, jstate, model, state = _setup(accum)
    idx = np.arange(4 * accum, dtype=np.int32).reshape(accum, 4)[:, ::-1].copy()
    jnew, jl = jloop.make_train_step(jmodel, jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(idx), 0.5)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    new, loss = loop.make_train_step(model, cfg)(state, tdata, idx, 0.5)
    assert new.step == 1 and int(jnew.step) == 1
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)

    jloss, jgrads = _jax_grads(jmodel, jcfg, jstate.params, data, idx)
    grad_fn = loop.make_grad_fn(model, cfg)
    parts = [grad_fn(state.params, tdata, i, torch.Generator()) for i in idx]
    grads = {k: sum(g[k] for _, g in parts) / accum for k in state.params}
    np.testing.assert_allclose(float(sum(l for l, _ in parts)) / accum, jloss, rtol=LOSS_RTOL)

    want_params = weights.basicnet_state_dict(jnew.params)
    for k, p in new.params.items():
        g, jg = grads[k].numpy(), jgrads[k].numpy()
        top = np.abs(jg).max()
        np.testing.assert_allclose(g, jg, atol=GRAD_RTOL * top, rtol=0, err_msg=k)
        # Adam's first step moves each parameter by about lr * 0.5 * sign(g):
        # equal wherever the two gradients have one sign; a flip may only
        # come from a gradient next to zero
        same = np.sign(g) == np.sign(jg)
        assert np.abs(jg[~same]).max(initial=0.0) <= GRAD_RTOL * top, k
        d = np.abs(p.numpy() - want_params[k].numpy())
        assert d[same].max(initial=0.0) <= PARAM_ATOL, (k, d[same].max())
        moved = np.abs(p.numpy() - state.params[k].numpy())
        assert np.abs(moved[np.abs(jg) > 1e-3 * top] - 0.5e-3).max() < 1e-5, k


def test_eval_step_matches_jax():
    cfg, jcfg, data, jmodel, jstate, model, state = _setup(1, seed=1)
    rng = np.random.default_rng(5)
    maps = rng.random((3, 48, 48, K)).astype(np.float32)
    jmse, jl2 = jloop.make_eval_step(jmodel, jcfg)(
        jstate, {"image": jnp.asarray(data["box"][:3]), "confmaps": jnp.asarray(maps)})
    mse, l2 = loop.make_eval_step(model, cfg)(
        state, {"image": torch.from_numpy(data["box"][:3]), "confmaps": torch.from_numpy(maps)})
    np.testing.assert_allclose(float(mse), float(jmse), rtol=1e-5)
    assert l2.shape == (3, K)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl2), atol=1e-4)


def test_plateau_scheduler_equals_jax():
    kw = dict(learning_rate=1.0, reduce_lr_factor=0.5, reduce_lr_patience=2,
              reduce_lr_min_delta=0.01, reduce_lr_cooldown=1, reduce_lr_min_lr=0.2)
    s, js = loop.PlateauScheduler(Config(**kw)), jloop.PlateauScheduler(JConfig(**kw))
    metrics = [1.0, 0.5, 0.5, 0.499, 0.5, 0.3, 0.3, 0.3, 0.3, 0.3, 0.29, 0.3] + [0.3] * 8
    for m in metrics:
        assert s.step(m) == js.step(m)
        assert s.state_dict() == js.state_dict()
    assert s.lr == 0.2
    s2 = loop.PlateauScheduler(Config(**kw))
    s2.load_state_dict(s.state_dict())
    assert s2.state_dict() == s.state_dict()


def test_params_bridge_round_trips_through_flax_apply():
    """Parameters the port trains, carried to the flax tree, serve through
    flax ``BasicNet.apply`` as the port's module computes them, and carry
    back unchanged."""
    cfg = Config(num_base_filters=8, compute_dtype="float32")
    model = build_model(cfg, (48, 48, 4), K)
    state = loop.create_train_state(model, cfg, seed=3, device="cpu")
    params = {k: v + 0.01 * torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
              for i, (k, v) in enumerate(state.params.items())}
    tree = weights.basicnet_params_from_state_dict(params)
    back = weights.basicnet_state_dict(tree)
    assert back.keys() == params.keys()
    for k in params:
        assert torch.equal(back[k], params[k]), k
    jmodel = jbuild_model(JConfig(num_base_filters=8, compute_dtype="float32"), (48, 48, 4), K)
    x = np.random.default_rng(0).random((2, 48, 48, 4), np.float32)
    want = np.asarray(jmodel.apply({"params": tree}, jnp.asarray(x), train=False))
    got = loop.make_predict_fn(model)(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_bf16_training_forward_casts_float32_params_like_flax():
    """bf16 compute over float32 parameters, each cast at its conv: within
    bf16 precision of flax's ``dtype=bf16, param_dtype=float32`` (the
    tolerance of tests/test_torch_models.py's bf16 module case)."""
    cfg = Config(num_base_filters=8)
    model = build_model(cfg, (48, 48, 4), K)
    assert model.dtype == torch.bfloat16
    state = loop.create_train_state(model, cfg, seed=2, device="cpu")
    assert all(v.dtype == torch.float32 for v in state.params.values())
    x = np.random.default_rng(1).random((2, 48, 48, 4), np.float32)
    jmodel = jbuild_model(JConfig(num_base_filters=8), (48, 48, 4), K)
    want = np.asarray(jmodel.apply({"params": weights.basicnet_params_from_state_dict(
        state.params)}, jnp.asarray(x), train=False))
    got = loop.make_predict_fn(model)(state.params, torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=3e-2 * np.abs(want).max())


def test_create_train_state_inits_like_flax():
    cfg = Config(num_base_filters=16, head_zero_init=True)
    model = build_model(cfg, (48, 48, 4), K)
    state = loop.create_train_state(model, cfg, seed=0, device="cpu")
    assert list(state.params) == [n for n, _ in model.named_parameters()]
    w = state.params["encoder.conv8.weight"]  # fan-in 9 * 64
    assert abs(float(w.std()) * (9 * 64) ** 0.5 - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / (9 * 64) ** 0.5 + 1e-6
    assert all(float(v.abs().max()) == 0.0 for k, v in state.params.items()
               if k.endswith("bias") or "deconv4" in k)
    again = loop.create_train_state(model, cfg.replace(head_zero_init=False), seed=0,
                                    device="cpu")
    assert torch.equal(again.params["encoder.conv1.weight"], state.params["encoder.conv1.weight"])
    assert float(again.params["decoder.deconv4.weight"].abs().max()) > 0
    from pose_estimation_amitai_torch.models.vit import ViTPoseNet

    with torch.device("meta"):
        vit = ViTPoseNet(4, 32, K, dim=16, depth=1, heads=2, dim_head=8)
    vstate = loop.create_train_state(vit, cfg, device="cpu")  # flax's law for the ViT too
    assert list(vstate.params) == [n for n, _ in vit.named_parameters()]
    assert float(vstate.params["transformer.final_norm.weight"].min()) == 1.0
    qkv = vstate.params["transformer.attn0.to_qkv.weight"]  # (out, in), fan-in 16
    assert qkv.shape == (48, 16) and "transformer.attn0.to_qkv.bias" not in vstate.params
    assert float(qkv.abs().max()) <= 2.0 / 0.87962566103423978 / 16 ** 0.5 + 1e-6
    assert float(vstate.params["decoder.deconv4.weight"].abs().max()) == 0.0  # head_zero_init


def test_dropout_draws_from_the_generator():
    x = torch.ones(64, 8, 16, 16)
    a = drop(x, 0.25, torch.Generator().manual_seed(0))
    assert set(torch.unique(a).tolist()) == {0.0, float(torch.tensor(1.0) / 0.75)}
    assert abs(float((a > 0).float().mean()) - 0.75) < 0.01
    assert torch.equal(a, drop(x, 0.25, torch.Generator().manual_seed(0)))
    assert drop(x, 0.0, None) is x
    net = BasicNet(4, K, filters=8, dtype=torch.float32, dropout=0.5)
    frames = torch.rand(2, 16, 16, 4)
    train_out = net(frames, torch.Generator().manual_seed(1))
    assert not torch.equal(train_out, net(frames, torch.Generator().manual_seed(2)))
    assert torch.equal(train_out, net(frames, torch.Generator().manual_seed(1)))
    net.eval()
    assert torch.equal(net(frames), net(frames, torch.Generator().manual_seed(3)))


def test_train_step_reproducible_and_steps_draw_anew(one_thread):
    """Same state and indices -> the same loss; the next step draws anew
    (tests/test_loop.py::test_train_step_reproducible); a camera-matrix
    batch (``P``, ``P_inv``) feeds the disentangled model, its running
    averages in the new state and the old state's as they were."""
    cfg = Config(num_base_filters=8, rotation_range=10.0, xy_shifts=2.0)
    model = build_model(cfg, (48, 48, 4), K)
    state = loop.create_train_state(model, cfg, device="cpu")
    data = {k: torch.from_numpy(v) for k, v in _data().items()}
    step = loop.make_train_step(model, cfg)
    idx = np.asarray([[0, 1, 2, 3]], np.int32)
    s_a, loss_a = step(state, data, idx)
    s_b, loss_b = step(state, data, idx)
    assert float(loss_a) == float(loss_b)
    assert all(torch.equal(s_a.params[k], s_b.params[k]) for k in s_a.params)
    _, loss_c = step(s_a.replace(params=state.params, opt_state=state.opt_state), data, idx)
    assert float(loss_c) != float(loss_a)
    cam_cfg = cfg.replace(model_type=C.ALL_CAMS_DISENTANGLED_PER_WING_CNN,
                          compute_dtype="float32")
    cam_model = build_model(cam_cfg, (48, 48, 16), 4 * K)
    cam_state = loop.create_train_state(cam_model, cam_cfg, device="cpu")
    P = torch.randn(8, 4, 3, 4, generator=torch.Generator().manual_seed(0))
    cam_data = {"box": data["box"].repeat(1, 1, 1, 4), "peaks": data["peaks"].repeat(1, 4, 1),
                "peak_vals": data["peak_vals"].repeat(1, 4), "P": P,
                "P_inv": torch.linalg.pinv(P)}
    s_a, loss_a = loop.make_train_step(cam_model, cam_cfg)(cam_state, cam_data, idx)
    s_b, loss_b = loop.make_train_step(cam_model, cam_cfg)(cam_state, cam_data, idx)
    assert float(loss_a) == float(loss_b) and np.isfinite(float(loss_a))
    assert set(s_a.batch_stats) == {f"bn{i}.running_{s}" for i in (1, 2, 3)
                                    for s in ("mean", "var")}
    assert all(torch.equal(s_a.batch_stats[n], s_b.batch_stats[n]) for n in s_a.batch_stats)
    assert not cam_state.batch_stats["bn3.running_mean"].any()
    assert s_a.batch_stats["bn3.running_mean"].any()


@pytest.fixture(scope="module")
def dataset():
    arrays = make_synthetic_arrays(num_frames=2, num_points=8, image_size=48, seed=0)
    return build_dataset(Config(), arrays, device="cpu")[0]


def test_resume_equals_uninterrupted_bit_for_bit(dataset, tmp_path):
    """k + m steps through a checkpoint equal k + m steps in one go, with
    augmentation, mask re-dilation and dropout on, in bf16 compute."""
    cfg = Config(num_base_filters=8, batch_size=4, accumulation_steps=2,
                 wings_masks_dilation=3)
    model = build_model(cfg, (48, 48, 4), K)
    step = loop.make_train_step(model, cfg)
    idx = [dataset.step_indices(cfg.batch_size, cfg.accumulation_steps) for _ in range(4)]
    state0 = loop.create_train_state(model, cfg, seed=7, device="cpu")

    def run(state, steps):
        losses = []
        for i in steps:
            state, loss = step(state, dataset.data, idx[i], 1.0 if i < 3 else 0.1)
            losses.append(float(loss))
        return state, losses

    whole, losses = run(state0, range(4))
    part, first = run(state0, range(2))
    ckpt = checkpoint.AsyncCheckpointer()
    ckpt.save_checkpoint(str(tmp_path), part, epoch=2, val_loss=0.25,
                         scheduler_state={"lr": 1e-3}, best_loss=0.2)
    ckpt.wait()
    fresh = loop.create_train_state(model, cfg, seed=0, device="cpu")
    restored, meta = checkpoint.restore_checkpoint(str(tmp_path), fresh)
    assert meta == {"epoch": 2, "val_loss": 0.25, "best_loss": 0.2,
                    "scheduler": {"lr": 1e-3}}
    assert restored.step == 2 and restored.seed == 7
    resumed, rest = run(restored, range(2, 4))
    assert first + rest == losses
    for k in whole.params:
        assert torch.equal(resumed.params[k], whole.params[k]), k
    for i, s in whole.opt_state["state"].items():
        for name, v in s.items():
            assert torch.equal(resumed.opt_state["state"][i][name], v), (i, name)
    ckpt.close()


def test_checkpoint_files_and_params(tmp_path):
    cfg = Config(num_base_filters=8)
    model = build_model(cfg, (48, 48, 4), K)
    state = loop.create_train_state(model, cfg, device="cpu")
    checkpoint.save_checkpoint(str(tmp_path), state, 0, 1.0)
    checkpoint.save_checkpoint(str(tmp_path), state.replace(step=5), 0, 0.5, best=True)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "best_model.pt", "checkpoint.pt", "checkpoint_meta.json"]
    params = checkpoint.load_params(str(tmp_path))  # best preferred
    assert all(torch.equal(params[k], state.params[k]) for k in params)
    checkpoint.save_params(str(tmp_path / "w.pt"), state.params)
    assert checkpoint.load_params(str(tmp_path / "w.pt")).keys() == state.params.keys()
    other = build_model(cfg.replace(num_base_filters=4), (48, 48, 4), K)
    with pytest.raises(ValueError, match="not the template"):
        checkpoint.restore_checkpoint(
            str(tmp_path), loop.create_train_state(other, cfg, device="cpu").replace(
                params={"x": torch.zeros(1)}))
    with pytest.raises(FileNotFoundError):
        checkpoint.load_params(str(tmp_path / "nothing"))
