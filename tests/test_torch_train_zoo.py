"""One train step of the CNN family's new models against JAX's
``make_train_step`` (CPU, float32, dropout 0, augmentation off, targets
re-rendered from the peaks, accumulation 1; the setup and tolerances of
tests/test_torch_train.py::test_train_step_matches_jax): ``MultiCamNet``
(torch flavour, and tf with the attention fusion), ``TwoWingsNet`` and
``C2FPerWing``, whose coarse parameters must come out bit-equal.

Both steps start from the same parameters: the port's seeded
``create_train_state`` (biases drawn nonzero), carried to flax by
``weights.state_dict_to_flax``. JAX's gradients are read back from its
Adam state after the step (the first moment is 0.1 g). The losses are held
to the float64 MSE of flax's forward on the step's batch: the port's within
LOSS_RTOL; JAX's own within JAX_MEAN_RTOL, because its float32 mean over
110,592 map values (``MultiCamNet``) lies 1.1e-5 of the value from it (the
port's about 1e-7), so the two float32 losses differ by a little more than
LOSS_RTOL from each other.
A gradient that is zero in exact arithmetic (the attention's key bias: a
constant added to a row of logits leaves its softmax as it was) is float32
noise of 1e-14 on both sides, held by the absolute floor ZERO_GRAD."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch import weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.models import build_model
from pose_estimation_amitai_torch.train import loop
from pose_estimation_amitai_tpu.config import Config as JConfig
from pose_estimation_amitai_tpu.models import build_model as jbuild_model
from pose_estimation_amitai_tpu.ops.gaussian import confmaps_from_peaks as jconfmaps
from pose_estimation_amitai_tpu.train import loop as jloop

from test_torch_resnet import one_thread  # noqa: F401 (a fixture)

GRAD_RTOL = 1e-4  # of each gradient tensor's largest element
# updated parameters where the two gradients agree in sign, beyond what the
# gradients' own difference moves Adam's first update lr * g / (|g| + eps):
# lr * eps * |g1 - g2| / ((|g1| + eps) (|g2| + eps)), large only where |g| is
# near eps (chip_smoke.py's train-phase rule)
PARAM_ATOL = 1e-6
ADAM_EPS = 1e-8
LR_SCALE = 0.5
LOSS_RTOL = 1e-5
# JAX's float32 mean of n values: about sqrt(n) * 2**-24 of the value, 2e-5
# at n = 110,592
JAX_MEAN_RTOL = 5e-5
ZERO_GRAD = 1e-12  # absolute floor of the gradient tolerance
B1 = 0.9  # Adam's first-moment decay: after one step mu = (1 - B1) g

# (model_type, in_channels, maps, extra config)
MODELS = [
    (C.ALL_CAMS_18_POINTS, 16, 12, {"arch_flavor": "torch"}),
    (C.ALL_CAMS_18_POINTS, 16, 12, {"arch_flavor": "tf", "do_attention": True}),
    (C.TWO_WINGS_TOGATHER, 5, 8, {"arch_flavor": "tf"}),
    (C.C2F_PER_WING, 4, 6, {"arch_flavor": "tf"}),
]


def _data(cin, k, seed=0, n=8):
    rng = np.random.default_rng(seed)
    return {"box": rng.random((n, 48, 48, cin), np.float32),
            "peaks": rng.uniform(4, 44, (n, k, 2)).astype(np.float32),
            "peak_vals": rng.uniform(0.5, 1.0, (n, k)).astype(np.float32)}


@pytest.mark.parametrize("mt, cin, k, extra", MODELS,
                         ids=[f"{m[0]}-{m[3]['arch_flavor']}" + ("-attention" if m[3].get(
                             "do_attention") else "") for m in MODELS])
def test_train_step_matches_jax(mt, cin, k, extra):
    kw = dict(model_type=mt, num_base_filters=8, compute_dtype="float32", dropout_ratio=0.0,
              do_augmentations=False, accumulation_steps=1, **extra)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    model = build_model(cfg, (48, 48, cin), k)
    state0 = loop.create_train_state(model, cfg, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(2)
    params = {n: v + 0.05 * torch.randn(v.shape, generator=gen) if n.endswith("bias") else v
              for n, v in state0.params.items()}
    state = state0.replace(params=params)
    data = _data(cin, k)
    idx = np.asarray([[3, 1, 6, 4]], np.int32)

    jmodel = jbuild_model(jcfg, (48, 48, cin), k)
    tree = jax.tree_util.tree_map(jnp.asarray, weights.state_dict_to_flax(params, model))
    jstate = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=tree,
                              opt_state=jloop.create_optimizer(jcfg).init(tree),
                              batch_stats={}, rng=jax.random.key(0))
    jnew, jl = jloop.make_train_step(jmodel, jcfg)(
        jstate, {n: jnp.asarray(v) for n, v in data.items()}, jnp.asarray(idx), LR_SCALE)
    tdata = {n: torch.from_numpy(v) for n, v in data.items()}
    new, loss = loop.make_train_step(model, cfg)(state, tdata, idx, LR_SCALE)
    maps = np.asarray(jax.jit(lambda p, x: jmodel.apply({"params": p}, x, train=False))(
        tree, jnp.asarray(data["box"][idx[0]])), np.float64)
    target = np.asarray(jconfmaps(jnp.asarray(data["peaks"][idx[0]]), (48, 48), jcfg.sigma),
                        np.float64) * data["peak_vals"][idx[0]][:, None, None, :]
    mse = float(np.mean(np.square(maps - target)))
    np.testing.assert_allclose(float(loss), mse, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(jl), mse, rtol=JAX_MEAN_RTOL)

    frozen = loop.frozen_names(model, params)
    assert bool(frozen) == (mt == C.C2F_PER_WING)
    _, grads = loop.make_grad_fn(model, cfg)(params, tdata, idx[0], torch.Generator())
    assert set(grads) == set(params) - frozen
    # JAX's gradients: its Adam first moment after one step, in the port's layout
    jgrads = weights.flax_to_state_dict(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1 - B1), jnew.opt_state[0].mu))
    want_params = weights.flax_to_state_dict(jnew.params)
    for name, p in new.params.items():
        if name in frozen:
            assert torch.equal(p, params[name]), name
            assert torch.equal(want_params[name], params[name]), name
            assert not jgrads[name].any(), name
            continue
        g, jg = grads[name].numpy(), jgrads[name].numpy()
        tol = GRAD_RTOL * np.abs(jg).max() + ZERO_GRAD
        np.testing.assert_allclose(g, jg, atol=tol, rtol=0, err_msg=name)
        same = np.sign(g) == np.sign(jg)
        assert np.abs(jg[~same]).max(initial=0.0) <= tol, name
        explained = cfg.learning_rate * LR_SCALE * ADAM_EPS * np.abs(g - jg) / (
            (np.abs(g) + ADAM_EPS) * (np.abs(jg) + ADAM_EPS))
        d = np.abs(p.numpy() - want_params[name].numpy()) - explained
        assert d[same].max(initial=0.0) <= PARAM_ATOL, (name, d[same].max())
    assert len(new.opt_state["state"]) == len(params) - len(frozen)


# ---------------------------------------------------------------------------
# the BatchNorm families and the camera-matrix model: the running averages
# ride in the state, threaded through the microbatches
# ---------------------------------------------------------------------------
STATS_RTOL = 1e-5  # of each running-average tensor's largest value
BN_GRAD_RTOL = 3e-3  # port vs JAX gradients, of the largest gradient
BN_EXACT_RTOL = 3e-4  # port vs float64 gradients, of the largest gradient


def _bn_family(which, dtype=torch.float32):
    """(model_type, port model in ``dtype``, JAX model, in_channels, maps) at
    48 px: the ResNet trunk at one block a stage (tf flavour, 16 stem
    features), GPTResNet as built, the disentangled model at filters 8."""
    from pose_estimation_amitai_torch.models import FourCamDisentangled
    from pose_estimation_amitai_torch.models import GPTResNet, ResNetHeatmapNet
    from pose_estimation_amitai_tpu.models.resnet import GPTResNet as JGPTResNet
    from pose_estimation_amitai_tpu.models.resnet import ResNetHeatmapNet as JResNetHeatmapNet

    if which == "resnet":
        kw = dict(flavor="tf", stem_features=16, stage_sizes=(1, 1, 1, 1))
        return (C.RESNET_18_POINTS_PER_WING, ResNetHeatmapNet(4, 6, dtype=dtype, **kw),
                JResNetHeatmapNet(out_channels=6, dtype=jnp.float32, **kw), 4, 6)
    if which == "gpt":
        return (C.GPTNET, GPTResNet(4, 6, dtype=dtype),
                JGPTResNet(out_channels=6, dtype=jnp.float32), 4, 6)
    mt = C.ALL_CAMS_DISENTANGLED_PER_WING_CNN
    kw = dict(model_type=mt, num_base_filters=8, compute_dtype="float32", dropout_ratio=0.0)
    return (mt, FourCamDisentangled(16, 24, filters=8, dropout=0.0, dtype=dtype),
            jbuild_model(JConfig(**kw), (48, 48, 16), 24), 16, 24)


def _cameras(n, seed=5):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((n, 4, 3, 4))
    P /= np.linalg.norm(P, axis=(-2, -1), keepdims=True)
    P_inv = np.linalg.pinv(P)
    P_inv /= np.linalg.norm(P_inv, axis=(-2, -1), keepdims=True)
    return {"P": P.astype(np.float32), "P_inv": P_inv.astype(np.float32)}


def _drawn_state(model, cfg, seed=1):
    """create_train_state with biases, BatchNorm scales and averages drawn."""
    state = loop.create_train_state(model, cfg, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    params = {n: v + 0.05 * torch.randn(v.shape, generator=gen) if v.dim() == 1 else v
              for n, v in state.params.items()}
    stats = {n: (0.5 + torch.rand(v.shape, generator=gen)) if n.endswith("var")
             else 0.1 * torch.randn(v.shape, generator=gen)
             for n, v in state.batch_stats.items()}
    return state.replace(params=params, batch_stats=stats)


@pytest.mark.parametrize("which, accum", [("resnet", 2), ("gpt", 2), ("disentangled", 1),
                                          ("disentangled", 2)])
def test_batchnorm_family_train_step_matches_jax(which, accum, one_thread):
    """Loss, running averages, gradients and the Adam-updated parameters
    after one step (float32, augmentation off, dropout 0) against JAX's
    ``make_train_step``, whose ``scan`` carries the averages from one
    microbatch to the next. Accumulation 2 for each family, 1 as well for
    the camera model (each case is a JAX compile of its own).

    A train-mode BatchNorm projects its input's gradient off the batch mean
    and the normalised input, and over the few values a channel has at this
    size (16 at GPTResNet's 2x2 bottom) float32 gradients lose digits there:
    JAX's lie 6.4e-4 of the model's largest gradient from the float64 ones
    (GPTResNet, accumulation 1), some tensors 19% of their own largest (a
    conv bias in front of a BatchNorm has an exact gradient of 0), the
    port's 1.3e-4 (accumulation 2). So the port's gradients are held to the same step
    computed in float64 (the port's modules in float64) within
    BN_EXACT_RTOL of the largest gradient, and to JAX's within BN_GRAD_RTOL
    of it."""
    mt, model, jmodel, cin, k = _bn_family(which)
    model64 = _bn_family(which, torch.float64)[1]
    kw = dict(model_type=mt, compute_dtype="float32", dropout_ratio=0.0,
              do_augmentations=False, accumulation_steps=accum)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    state = _drawn_state(model, cfg)
    assert state.batch_stats and all(v.dtype == torch.float32 for v in state.batch_stats.values())
    data = _data(cin, k)
    if which == "disentangled":
        data.update(_cameras(8))
    idx = np.asarray([[3, 1, 6, 4], [0, 7, 2, 5]][:accum], np.int32)

    tree = jax.tree_util.tree_map(jnp.asarray, weights.state_dict_to_flax(state.params, model))
    stats_tree = jax.tree_util.tree_map(jnp.asarray, weights.batch_stats_to_flax(state.batch_stats))
    jstate = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=tree,
                              opt_state=jloop.create_optimizer(jcfg).init(tree),
                              batch_stats=stats_tree, rng=jax.random.key(0))
    jnew, jl = jloop.make_train_step(jmodel, jcfg)(
        jstate, {n: jnp.asarray(v) for n, v in data.items()}, jnp.asarray(idx), LR_SCALE)
    tdata = {n: torch.from_numpy(v) for n, v in data.items()}
    new, loss = loop.make_train_step(model, cfg)(state, tdata, idx, LR_SCALE)
    np.testing.assert_allclose(float(loss), float(jl), rtol=JAX_MEAN_RTOL)
    assert all(torch.equal(state.batch_stats[n], v) for n, v in
               _drawn_state(model, cfg).batch_stats.items())  # the old state as it was

    want_stats = weights.flax_to_state_dict({}, None, jax.tree_util.tree_map(
        np.asarray, jnew.batch_stats))
    assert set(new.batch_stats) == set(want_stats) == set(state.batch_stats)
    for name, w in want_stats.items():
        w = w.numpy()
        np.testing.assert_allclose(new.batch_stats[name].numpy(), w, rtol=0,
                                   atol=STATS_RTOL * np.abs(w).max(), err_msg=name)

    def mean_grads(m, params, stats):
        fn = loop.make_grad_fn(m, cfg)
        parts = [fn(params, tdata, i, torch.Generator(), stats) for i in idx]
        np.testing.assert_allclose(sum(float(l) for l, _ in parts) / accum, float(loss),
                                   rtol=LOSS_RTOL)
        return {n: (sum(g[n] for _, g in parts) / accum).double().numpy() for n in params}

    grads = mean_grads(model, state.params, state.batch_stats)
    exact = mean_grads(model64, {n: v.double() for n, v in state.params.items()},
                       {n: v.double() for n, v in state.batch_stats.items()})
    jgrads = {n: v.numpy() for n, v in weights.flax_to_state_dict(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1 - B1), jnew.opt_state[0].mu), model).items()}
    top = max(np.abs(g).max() for g in exact.values())
    want_params = weights.flax_to_state_dict(jnew.params, model)
    for name, p in new.params.items():
        g, jg = grads[name], jgrads[name]
        np.testing.assert_allclose(g, exact[name], atol=BN_EXACT_RTOL * top, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(g, jg, atol=BN_GRAD_RTOL * top, rtol=0, err_msg=name)
        same = np.sign(g) == np.sign(jg)
        assert np.abs(jg[~same]).max(initial=0.0) <= BN_GRAD_RTOL * top, name
        explained = cfg.learning_rate * LR_SCALE * ADAM_EPS * np.abs(g - jg) / (
            (np.abs(g) + ADAM_EPS) * (np.abs(jg) + ADAM_EPS))
        d = np.abs(p.numpy() - want_params[name].numpy()) - explained
        assert d[same].max(initial=0.0) <= PARAM_ATOL, (name, d[same].max())


def test_batchnorm_family_resume_is_bit_for_bit(tmp_path, one_thread):
    """k + m steps through a checkpoint equal k + m steps in one go, the
    running averages included, on the camera model: augmentation on (each
    view's warp folded into its camera), dropout on, accumulation 2."""
    from pose_estimation_amitai_torch.train import checkpoint

    mt, _, _, cin, k = _bn_family("disentangled")
    cfg = Config(model_type=mt, accumulation_steps=2, rotation_range=20.0, xy_shifts=3.0,
                 num_base_filters=8, compute_dtype="float32")
    model = build_model(cfg, (48, 48, cin), k)
    data = {n: torch.from_numpy(v) for n, v in _data(cin, k).items()}
    data.update({n: torch.from_numpy(v) for n, v in _cameras(8).items()})
    step = loop.make_train_step(model, cfg)
    idx = [np.asarray([[3, 1], [6, 4]], np.int32), np.asarray([[0, 7], [2, 5]], np.int32)]
    state0 = loop.create_train_state(model, cfg, seed=2, device="cpu")
    whole = state0
    for i in idx:
        whole, _ = step(whole, data, i)
    part, _ = step(state0, data, idx[0])
    checkpoint.save_checkpoint(str(tmp_path), part, epoch=0, val_loss=0.0)
    restored, _ = checkpoint.restore_checkpoint(
        str(tmp_path), loop.create_train_state(model, cfg, seed=3, device="cpu"))
    assert restored.step == 1 and set(restored.batch_stats) == set(part.batch_stats)
    assert all(torch.equal(restored.batch_stats[n], v) for n, v in part.batch_stats.items())
    restored, _ = step(restored, data, idx[1])
    for tree in ("params", "batch_stats"):
        got, want = getattr(restored, tree), getattr(whole, tree)
        assert all(torch.equal(got[n], want[n]) for n in want), tree
    assert any(not torch.equal(whole.batch_stats[n], state0.batch_stats[n])
               for n in state0.batch_stats)
