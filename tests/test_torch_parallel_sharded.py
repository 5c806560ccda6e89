"""The port's data-parallel step (parallel/sharded.py) in a 2-rank gloo
world on the CPU (filters 8, (48, 48, 4) frames, accumulation 2 of 4
rows):

* float32, no augmentation, dropout 0, against JAX's
  ``make_sharded_train_step`` on a 2-device mesh from the same parameters:
  loss within 2e-4 relative, parameters within JAX's own bounds (rtol 2e-3,
  atol 2e-5: tests/test_sharded.py) wherever the two gradients have one
  sign, a flip only where JAX's gradient is within 1e-4 of its largest;
* augmentation (with mask re-dilation) and dropout 0.5 on, against the
  port's 1-rank step on the same global batch: the same draws, so the loss
  within 1e-5 relative and the parameters within 1e-5 beyond what the
  gradients' difference moves Adam's first update;
* RESNET_18_POINTS_PER_WING (64 px) at 2 ranks against 1 rank: the
  cross-replica BatchNorm's running averages within rtol 2e-3 / atol 2e-5
  and changed from their initial values (tests/test_sharded.py);

and ``microbatch_arrays`` against JAX's."""

import numpy as np
import pytest
import torch

from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch import weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.models import build_model
from pose_estimation_amitai_torch.parallel.mesh import make_mesh
from pose_estimation_amitai_torch.parallel.sharded import (
    make_sharded_train_step,
    shard_microbatches,
    shard_state,
)
from pose_estimation_amitai_torch.train import loop

from test_torch_parallel_mesh import World, one_thread

K = 6
ACCUM, BATCH = 2, 4
LR = 1e-3
ADAM_EPS = 1e-8
BASE = dict(num_base_filters=8, compute_dtype="float32", accumulation_steps=ACCUM,
            batch_size=BATCH)
CASES = {
    "jax": dict(BASE, do_augmentations=False, dropout_ratio=0.0),
    "augmented": dict(BASE, do_augmentations=True, rotation_range=10.0, xy_shifts=2.0,
                      wings_masks_dilation=3, dropout_ratio=0.5),
    "resnet": dict(BASE, model_type=C.RESNET_18_POINTS_PER_WING, do_augmentations=False),
}
HW = {"jax": 48, "augmented": 48, "resnet": 64}


def _batch(case: str) -> dict[str, np.ndarray]:
    """(accum, B, ...) arrays; ``peaks`` where the step re-renders targets."""
    hw, rng = HW[case], np.random.default_rng(0)
    out = {"image": rng.random((ACCUM, BATCH, hw, hw, 4), np.float32),
           "confmaps": rng.random((ACCUM, BATCH, hw, hw, K), np.float32)}
    if case == "augmented":
        out["peaks"] = rng.uniform(6, hw - 6, (ACCUM, BATCH, K, 2)).astype(np.float32)
        out["peak_vals"] = rng.uniform(0.5, 1.0, (ACCUM, BATCH, K)).astype(np.float32)
    return out


def _state(case: str):
    cfg = Config(**CASES[case])
    with torch.device("meta"):  # the geometry; parameters live in the state
        model = build_model(cfg, (HW[case], HW[case], 4), K)
    return cfg, model, loop.create_train_state(model, cfg, seed=3, device="cpu")


def _numpy(state, loss, weights: bool = True) -> dict:
    """The loss, the running averages and (``weights``) the parameters and
    the gradients, read back from Adam's first moment, (1 - b1) g."""
    out = {"loss": float(loss), "stats": {k: v.numpy() for k, v in state.batch_stats.items()}}
    if weights:
        out["params"] = {k: v.numpy() for k, v in state.params.items()}
        out["grads"] = {k: s["exp_avg"].numpy() / 0.1
                        for k, s in zip(state.params, state.opt_state["state"].values())}
    return out


def _sharded_body(rank, world):
    mesh = make_mesh((), "cpu")
    out = {}
    for case in CASES:
        cfg, model, state = _state(case)
        batch = shard_microbatches(mesh, {k: torch.from_numpy(v) for k, v in _batch(case).items()})
        step = make_sharded_train_step(model, cfg, mesh)
        new, loss = step(shard_state(mesh, state), batch, 1.0)
        out[case] = _numpy(new, loss, weights=case != "resnet")
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Started first: the ranks run while the JAX reference compiles."""
    return World(_sharded_body, 2, tmp_path_factory.mktemp("sharded"))


@pytest.fixture(scope="module")
def two_ranks(world, jax_step, one_rank):
    """Joined after the references made while it ran."""
    return world.results()


@pytest.fixture(scope="module")
def one_rank(world):
    """The port's 1-rank results, made while the world runs."""
    with one_thread():
        return {case: _one_rank(case) for case in ("augmented", "resnet")}


def _one_rank(case: str) -> dict:
    """The port's plain step on the whole batch (stored maps as targets)."""
    cfg, model, state = _state(case)
    b = _batch(case)
    n = ACCUM * BATCH
    data = {("box" if k == "image" else k): torch.from_numpy(v.reshape(n, *v.shape[2:]))
            for k, v in b.items()}
    idx = np.arange(n).reshape(ACCUM, BATCH)
    new, loss = loop.make_train_step(model, cfg)(state, data, idx, 1.0)
    return _numpy(new, loss, weights=case != "resnet")


def _assert_adam_close(got: dict, want: dict, grad_rtol: float, atol: float, rtol: float = 0.0):
    """Parameters after Adam's first step, lr * g / (|g| + eps): equal where
    the gradients have one sign, beyond what their difference explains; a
    flip of sign only where the reference gradient is next to zero."""
    for k, p in got["params"].items():
        g, wg = got["grads"][k], want["grads"][k]
        top = np.abs(wg).max()
        np.testing.assert_allclose(g, wg, atol=grad_rtol * top, rtol=0, err_msg=k)
        same = np.sign(g) == np.sign(wg)
        assert np.abs(wg[~same]).max(initial=0.0) <= grad_rtol * top, k
        explained = LR * ADAM_EPS * np.abs(g - wg) / ((np.abs(g) + ADAM_EPS) * (np.abs(wg) + ADAM_EPS))
        bound = atol + rtol * np.abs(want["params"][k]) + explained
        excess = (np.abs(p - want["params"][k]) - bound)[same]
        assert excess.max(initial=-1.0) <= 0.0, (k, excess.max())


@pytest.fixture(scope="module")
def jax_step(world):
    """JAX's make_sharded_train_step on a 2-device mesh, from the port's
    initial parameters."""
    import jax
    import jax.numpy as jnp
    import optax
    from pose_estimation_amitai_tpu.config import Config as JConfig
    from pose_estimation_amitai_tpu.models import build_model as jbuild_model
    from pose_estimation_amitai_tpu.parallel.mesh import make_mesh as jmake_mesh
    from pose_estimation_amitai_tpu.parallel import sharded as jsharded
    from pose_estimation_amitai_tpu.train import loop as jloop

    jcfg = JConfig(**CASES["jax"])
    jmodel = jbuild_model(jcfg, (48, 48, 4), K)
    _, model, state = _state("jax")
    params = jax.tree_util.tree_map(jnp.asarray, weights.state_dict_to_flax(state.params, model))
    b = {k: jnp.asarray(v) for k, v in _batch("jax").items()}
    jstate = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=optax.adam(LR).init(params), batch_stats={},
                              rng=jax.random.key(3))
    mesh = jmake_mesh((2,), jax.devices()[:2])
    new, loss = jsharded.make_sharded_train_step(jmodel, jcfg, mesh)(
        jsharded.shard_state(mesh, jstate), jsharded.shard_microbatches(mesh, b),
        jnp.asarray(1.0))
    mu = new.opt_state[0].mu
    return {"loss": float(loss),
            "params": {k: v.numpy() for k, v in
                       weights.flax_to_state_dict(jax.device_get(new.params), model).items()},
            "grads": {k: v.numpy() / 0.1 for k, v in
                      weights.flax_to_state_dict(jax.device_get(mu), model).items()}}


def test_two_rank_step_matches_jax_sharded_step(jax_step, two_ranks):
    for res in two_ranks:
        got = res["jax"]
        np.testing.assert_allclose(got["loss"], jax_step["loss"], rtol=2e-4)
        _assert_adam_close(got, jax_step, grad_rtol=1e-4, atol=2e-5, rtol=2e-3)


def test_two_rank_step_with_augmentation_equals_one_rank(one_rank, two_ranks):
    """The draws are the whole batch's on every rank: 2 ranks train on what
    1 rank trains on, and end with the same state."""
    want = one_rank["augmented"]
    for res in two_ranks:
        got = res["augmented"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        _assert_adam_close(got, want, grad_rtol=1e-4, atol=1e-5)
    for k in want["params"]:
        np.testing.assert_array_equal(two_ranks[0]["augmented"]["params"][k],
                                      two_ranks[1]["augmented"]["params"][k])


def test_sharded_batchnorm_cross_replica(one_rank, two_ranks):
    """The running averages are the whole batch's: equal on both ranks, as
    1 rank's on the whole batch, and moved from their initial values."""
    want = one_rank["resnet"]
    cfg = Config(**CASES["resnet"])
    with torch.device("meta"):
        model = build_model(cfg, (HW["resnet"], HW["resnet"], 4), K)
    initial = loop.init_batch_stats(model, "cpu")
    assert want["stats"]
    for res in two_ranks:
        got = res["resnet"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-4)
        assert any(not np.allclose(got["stats"][k], v.numpy())
                   for k, v in initial.items()), "batch_stats did not update"
        for k, v in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k], v, rtol=2e-3, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("host", [False, True])
def test_microbatch_arrays_match_jax(host):
    import jax.numpy as jnp
    from pose_estimation_amitai_tpu.config import Config as JConfig
    from pose_estimation_amitai_tpu.data import pipeline as jpipeline

    from pose_estimation_amitai_torch.data import pipeline

    rng = np.random.default_rng(1)
    data = {"box": rng.random((10, 48, 48, 4), np.float32),
            "confmaps": rng.random((10, 48, 48, K), np.float32)}
    cfg_kw = dict(val_fraction=0.2, seed=4)
    cls, jcls = ((pipeline.HostDataset, jpipeline.HostDataset) if host
                 else (pipeline.DeviceDataset, jpipeline.DeviceDataset))
    ds = cls(Config(**cfg_kw), data, device="cpu")
    jds = jcls(JConfig(**cfg_kw), data)
    idx = ds.step_indices(4, 2)
    np.testing.assert_array_equal(idx, jds.step_indices(4, 2))
    got, want = ds.microbatch_arrays(idx), jds.microbatch_arrays(idx)
    assert set(got) == set(want) == {"image", "confmaps", "peaks", "peak_vals"}
    for k in ("image", "confmaps"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("peaks", "peak_vals"):  # each package's sub-pixel decode
        assert got[k].shape == tuple(jnp.shape(want[k]))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4)


# ---------------------------------------------------------------------------
# the Trainer on a data mesh and on a (data 1, model 2) mesh, 2 ranks
# ---------------------------------------------------------------------------
TRAINER = dict(epochs=2, batch_size=4, batches_per_epoch=2, num_base_filters=8,
               compute_dtype="float32", do_augmentations=True, rotation_range=10.0,
               xy_shifts=2.0, val_fraction=0.5, seed=0, async_checkpoint=False)
MESHES = {"data": (), "model": (1, 2)}


def _trainer_arrays():
    from pose_estimation_amitai_torch.data import make_synthetic_arrays

    return make_synthetic_arrays(num_frames=4, num_points=6, image_size=48, seed=0)


def _trainer_body(rank, world, out: str):
    from pose_estimation_amitai_torch import viz
    from pose_estimation_amitai_torch.train.checkpoint import load_variables
    from pose_estimation_amitai_torch.train.trainer import Trainer

    viz.available = lambda: False  # this process draws no PNG
    res = {}
    for name, shape in MESHES.items():
        tr = Trainer(Config(base_output_path=f"{out}/{name}", mesh_shape=shape, **TRAINER),
                     arrays=_trainer_arrays(), device="cpu")
        res[name] = {"mesh": tr.mesh.mesh_dim_names, "history": tr.train(),
                     "run_path": tr.run_path}
        if rank == 0:  # the checkpoint holds the whole weights
            res[name]["best"] = {k: v.numpy() for k, v in load_variables(tr.run_path)[0].items()}
    return res


@pytest.fixture(scope="module")
def trainer_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_trainer")
    return World(_trainer_body, 2, out, str(out)), out


@pytest.fixture(scope="module")
def one_process_trainer(trainer_world):
    from pose_estimation_amitai_torch import viz
    from pose_estimation_amitai_torch.train.checkpoint import load_variables
    from pose_estimation_amitai_torch.train.trainer import Trainer

    available, viz.available = viz.available, lambda: False
    try:
        with one_thread():
            tr = Trainer(Config(base_output_path=str(trainer_world[1] / "one"), **TRAINER),
                         arrays=_trainer_arrays(), device="cpu")
            history = tr.train()
    finally:
        viz.available = available
    assert tr.mesh is None
    return history, {k: v.numpy() for k, v in load_variables(tr.run_path)[0].items()}


def test_trainer_on_a_mesh_equals_one_process(one_process_trainer, trainer_world):
    """Both ranks see one history, the first rank's run directory, and the
    one-process Trainer's losses and best weights: the data mesh and the
    column-split weights train as one process does."""
    ranks = trainer_world[0].results()
    history, best = one_process_trainer
    for name in MESHES:
        assert ranks[0][name]["run_path"] == ranks[1][name]["run_path"]
        assert ranks[0][name]["mesh"] == (("data",) if name == "data" else ("data", "model"))
        for res in ranks:
            for key in ("train_loss", "val_loss"):
                np.testing.assert_allclose(res[name]["history"][key], history[key],
                                           rtol=1e-4, err_msg=f"{name} {key}")
        for k, v in best.items():
            np.testing.assert_allclose(ranks[0][name]["best"][k], v, rtol=2e-3, atol=2e-5,
                                       err_msg=f"{name} {k}")
