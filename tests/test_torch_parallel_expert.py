"""Expert parallelism (parallel/expert.py) in a 4-rank gloo world on the
CPU at (data 2, expert 2): ``MoEFeedForward`` (dim 16, hidden 32, 4
experts) on JAX's initial parameters, its output against ``apply_dense``
and against JAX's ``apply`` on the same mesh within 1e-5, and the
gradients of every parameter and of the tokens against ``apply_dense``'s
within 1e-5 of their largest; each rank holds E / ep experts; the top-1
gate is one-hot per token; the parameter bridge both ways."""

import numpy as np
import pytest
import torch

from pose_estimation_amitai_torch import weights
from pose_estimation_amitai_torch.parallel.expert import (
    EXPERT_KEYS,
    MoEFeedForward,
    make_expert_mesh,
)
from pose_estimation_amitai_torch.parallel.mesh import axis_index

from test_torch_parallel_mesh import World

DIM, HIDDEN, E = 16, 32, 4
B, T = 4, 6


def _xw():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((B, T, DIM)).astype(np.float32),
            rng.standard_normal((B, T, DIM)).astype(np.float32))


def _moe_body(rank, world, params: dict):
    mesh = make_expert_mesh(2, 2, "cpu")
    moe = MoEFeedForward(mesh, dim=DIM, hidden_dim=HIDDEN, num_experts=E)
    local = moe.shard_params(weights.moe_params_to_torch(params))
    i = axis_index(mesh, "data")
    x, w = (a[i * 2 : (i + 1) * 2] for a in _xw())
    live = {k: v.clone().requires_grad_() for k, v in local.items()}
    xx = torch.from_numpy(x).requires_grad_()
    out = moe.apply(live, xx)
    (out * torch.from_numpy(w)).sum().backward()
    return {"data": i, "expert": axis_index(mesh, "expert"), "out": out.detach().numpy(),
            "grads": {k: v.grad.numpy() for k, v in live.items()}, "x_grad": xx.grad.numpy(),
            "shapes": {k: tuple(v.shape) for k, v in local.items()},
            "gates": moe._gates(local["gate"], xx.detach()).numpy()}


@pytest.fixture(scope="module")
def jax_moe():
    import jax
    from pose_estimation_amitai_tpu.parallel import expert as jexpert

    mesh = jexpert.make_expert_mesh(2, 2)
    moe = jexpert.MoEFeedForward(mesh, dim=DIM, hidden_dim=HIDDEN, num_experts=E)
    params = {k: np.asarray(v) for k, v in moe.init(jax.random.key(0)).items()}
    return moe, params


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_moe):
    return World(_moe_body, 4, tmp_path_factory.mktemp("moe"), jax_moe[1])


@pytest.fixture(scope="module")
def jax_out(jax_moe, world):
    import jax

    moe, params = jax_moe
    return np.asarray(jax.jit(moe.apply)(moe.shard_params(params), _xw()[0]))


@pytest.fixture(scope="module")
def moe_world(world, jax_out):
    return world.results()


def _dense(params: dict):
    moe = MoEFeedForward(None, dim=DIM, hidden_dim=HIDDEN, num_experts=E)
    live = {k: v.requires_grad_() for k, v in weights.moe_params_to_torch(params).items()}
    x, w = _xw()
    xx = torch.from_numpy(x).requires_grad_()
    out = moe.apply_dense(live, xx)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), {k: v.grad.numpy() for k, v in live.items()}, xx.grad.numpy()


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=what)


def test_moe_matches_dense_and_jax(moe_world, jax_moe, jax_out):
    want, want_grads, want_gx = _dense(jax_moe[1])
    np.testing.assert_allclose(want, jax_out, rtol=0, atol=1e-5)
    for res in moe_world:
        rows = slice(2 * res["data"], 2 * res["data"] + 2)
        np.testing.assert_allclose(res["out"], want[rows], rtol=0, atol=1e-5)
        np.testing.assert_allclose(res["out"], jax_out[rows], rtol=0, atol=1e-5)


def test_moe_grads_match_dense(moe_world, jax_moe):
    """Each data row's gradients: the two data ranks' sum is the dense
    gradient; within a data row, the expert ranks' blocks of the stacks and
    the same gate and token gradients."""
    _, want_grads, want_gx = _dense(jax_moe[1])
    le = E // 2
    for k, want in want_grads.items():
        total = np.zeros_like(want)
        for res in moe_world:
            g = res["grads"][k]
            if k in EXPERT_KEYS:
                e = res["expert"]
                total[e * le : (e + 1) * le] += g
            else:
                total += g / 2  # the two expert ranks of a data row hold the same gate gradient
        _close(total, want, k)
    for res in moe_world:
        rows = slice(2 * res["data"], 2 * res["data"] + 2)
        _close(res["x_grad"], want_gx[rows], "tokens")


def test_moe_params_are_expert_sharded_and_routing_is_top1(moe_world):
    for res in moe_world:
        assert res["shapes"]["w1"] == (E // 2, DIM, HIDDEN)
        assert res["shapes"]["b2"] == (E // 2, DIM)
        assert res["shapes"]["gate"] == (DIM, E)
        nonzero = (res["gates"] > 0).sum(axis=-1)
        assert (nonzero == 1).all()


def test_moe_param_bridge_round_trips(jax_moe):
    params = jax_moe[1]
    back = weights.moe_params_to_numpy(weights.moe_params_to_torch(params))
    assert set(back) == set(params)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
