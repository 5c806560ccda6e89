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
