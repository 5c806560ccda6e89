"""Tensor parallelism (parallel/tensor.py) in a 4-rank gloo world on the
CPU: the flagship BasicNet (filters 8, (48, 48, 4) frames, float32, no
augmentation, dropout 0) on a (data 2, model 2) mesh against the port's
1-rank step on the same batch, at JAX's bounds for the same check
(tests/test_sharded.py ``test_tensor_parallel_annotation_equivalence``:
loss rtol 2e-4, parameters rtol 2e-3 / atol 2e-5). Two steps, the state
gathered and split again between them, so the Adam moments are split too.
The split follows the module types (a transposed conv's output features
are dim 1 of its weight)."""

import numpy as np
import pytest
import torch

from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.models import build_model
from pose_estimation_amitai_torch.parallel.mesh import MODEL_AXIS, make_mesh
from pose_estimation_amitai_torch.parallel.sharded import make_sharded_train_step, shard_microbatches
from pose_estimation_amitai_torch.parallel.tensor import gather_state_tp, param_specs, shard_state_tp
from pose_estimation_amitai_torch.train import loop

from test_torch_parallel_mesh import World, one_thread

K = 6
ACCUM, BATCH = 2, 4
CFG = Config(num_base_filters=8, compute_dtype="float32", accumulation_steps=ACCUM,
             batch_size=BATCH, do_augmentations=False, dropout_ratio=0.0)


def _batches() -> list[dict[str, np.ndarray]]:
    rng = np.random.default_rng(0)
    return [{"image": rng.random((ACCUM, BATCH, 48, 48, 4), np.float32),
             "confmaps": rng.random((ACCUM, BATCH, 48, 48, K), np.float32)} for _ in range(2)]


def _start():
    with torch.device("meta"):  # the geometry; parameters live in the state
        model = build_model(CFG, (48, 48, 4), K)
    return model, loop.create_train_state(model, CFG, seed=5, device="cpu")


def _tp_body(rank, world):
    mesh = make_mesh((2, 2), "cpu")
    model, state = _start()
    state = shard_state_tp(mesh, state, model)
    step = make_sharded_train_step(model, CFG, mesh)
    out = {"specs": param_specs(mesh, model), "losses": []}
    for i, b in enumerate(_batches()):
        state, loss = step(state, shard_microbatches(
            mesh, {k: torch.from_numpy(v) for k, v in b.items()}), 1.0)
        out["losses"].append(float(loss))
        if i == 0:
            out["local"] = {k: tuple(v.shape) for k, v in state.params.items()}
            out["moments"] = {k: tuple(s["exp_avg"].shape) for k, s in
                              zip(state.params, state.opt_state["state"].values())}
            # a resumed run splits a state whose moments exist
            state = shard_state_tp(mesh, gather_state_tp(mesh, state, model), model)
    whole = gather_state_tp(mesh, state, model)
    out["params"] = {k: v.numpy() for k, v in whole.params.items()}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(_tp_body, 4, tmp_path_factory.mktemp("tp"))


@pytest.fixture(scope="module")
def one_rank(world):
    """The port's 1-rank steps on the same batches, made while the world
    runs."""
    model, state = _start()
    step = loop.make_train_step(model, CFG)
    n = ACCUM * BATCH
    losses = []
    with one_thread():
        for b in _batches():
            data = {"box": torch.from_numpy(b["image"].reshape(n, 48, 48, 4)),
                    "confmaps": torch.from_numpy(b["confmaps"].reshape(n, 48, 48, K))}
            state, loss = step(state, data, np.arange(n).reshape(ACCUM, BATCH), 1.0)
            losses.append(float(loss))
    return state, losses


@pytest.fixture(scope="module")
def tp_world(world, one_rank):
    return world.results()


def test_tensor_parallel_matches_one_rank(one_rank, tp_world):
    state, losses = one_rank
    for res in tp_world:
        np.testing.assert_allclose(res["losses"], losses, rtol=2e-4)
        for k, v in state.params.items():
            np.testing.assert_allclose(res["params"][k], v.numpy(), rtol=2e-3, atol=2e-5,
                                       err_msg=k)


def test_weights_and_moments_are_split(tp_world):
    """Column blocks by module type: a conv's output channels (dim 0), a
    transposed conv's (dim 1); biases replicate. Each rank holds half of
    each split weight and of its Adam moments."""
    model, state = _start()
    specs = tp_world[0]["specs"]
    assert specs["encoder.conv1.weight"] == 0 and specs["decoder.deconv1.weight"] == 1
    assert all(specs[k] is None for k in specs if k.endswith(".bias"))
    split = [k for k, d in specs.items() if d is not None]
    assert split
    for res in tp_world:
        for k, v in state.params.items():
            want = list(v.shape)
            if specs[k] is not None:
                want[specs[k]] //= 2
            assert res["local"][k] == tuple(want), k
            assert res["moments"][k] == tuple(want), k
    assert MODEL_AXIS == "model"
