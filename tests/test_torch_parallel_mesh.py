"""The port's process groups, meshes and differentiable collectives
(parallel/mesh.py) in gloo worlds on the CPU, and the helper the other
``test_torch_parallel_*`` files run their worlds with.

A world is ``world`` processes started with the ``spawn`` context, each on
one intra-op thread, joined to a gloo group through a FileStore under the
test's ``tmp_path`` (never a fixed TCP port: several test workers run at
once) with a 60 s timeout on the group and a join timeout on the
processes, so a hang fails its test. The rank bodies are top-level
functions of the test files, which import torch and the port alone: jax is
imported only by the reference fixtures, in the test process."""

import contextlib
import os
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.parallel import mesh as pmesh

GROUP_TIMEOUT = timedelta(seconds=60)
JOIN_TIMEOUT = 180.0  # seconds for a whole world, start-up included


def _rank_main(fn, rank: int, world: int, init_file: str, out_dir: str, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class World:
    """``fn(rank, world, *args)`` started in each process of a gloo world;
    :meth:`results` joins them (the caller may work meanwhile) and returns
    the ranks' return values, in rank order."""

    def __init__(self, fn, world: int, tmp_path, *args):
        self.world = world
        self.out = tmp_path / f"world{time.monotonic_ns()}"
        self.out.mkdir()
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(fn, r, world, str(self.out / "rdzv"), str(self.out), args))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + JOIN_TIMEOUT
        self._results = None

    def results(self) -> list:
        if self._results is None:
            for p in self.procs:
                p.join(max(0.0, self.deadline - time.monotonic()))
            hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
            assert not hung, f"ranks {hung} of a world of {self.world} did not finish"
            codes = [p.exitcode for p in self.procs]
            assert codes == [0] * self.world, f"exit codes {codes}"
            self._results = [torch.load(self.out / f"rank{r}.pt", weights_only=False)
                             for r in range(self.world)]
        return self._results


@contextlib.contextmanager
def one_thread():
    """One intra-op thread in the test process while a world runs beside it
    (tests/test_torch_resnet.py ``one_thread``: busy cores make eight
    threads wait on each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def run_world(fn, world: int, tmp_path, *args) -> list:
    """:class:`World` started and joined."""
    return World(fn, world, tmp_path, *args).results()


# ---------------------------------------------------------------------------
# a 4-rank world: meshes, sharding, the collectives forward and backward
# ---------------------------------------------------------------------------
def _stacked(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((4, 3, 5)).astype(np.float32)


def _mesh_body(rank, world):
    res = {}
    m = pmesh.make_mesh((), "cpu")
    res["1d"] = (m.mesh_dim_names, pmesh.axis_size(m, "data"), pmesh.axis_index(m, "data"))
    m2 = pmesh.make_mesh((2, 2), "cpu")
    res["2d"] = (m2.mesh_dim_names, pmesh.axis_size(m2, "data"), pmesh.axis_size(m2, "model"),
                 pmesh.axis_index(m2, "data"), pmesh.axis_index(m2, "model"))
    mp2 = pmesh.make_2d_mesh(2, 2, "pipe", "cpu")
    res["pipe"] = (mp2.mesh_dim_names, pmesh.axis_index(mp2, "pipe"))
    try:
        pmesh.make_mesh((3,), "cpu")
    except ValueError as e:
        res["bad"] = str(e)
    batch = {"x": torch.arange(8.0).reshape(8, 1), "y": [torch.arange(8)]}
    res["rows"] = pmesh.shard_batch(m, batch)
    res["bcast"] = pmesh.shard_params(m, {"w": torch.full((2,), float(rank))})["w"]

    group = m.get_group("data")
    x = torch.from_numpy(_stacked()[rank]).requires_grad_()
    w = torch.from_numpy(_stacked(1)[rank])
    y = pmesh.ppermute(x, group, 1)
    (y * w).sum().backward()
    res["ppermute"] = (y.detach(), x.grad.clone())
    x2 = x.detach().clone().requires_grad_()
    y2 = pmesh.ppermute(x2, group, -1)
    (y2 * w).sum().backward()
    res["ppermute_back"] = (y2.detach(), x2.grad.clone())

    # psum: each rank's loss its own -> the cotangents all-reduced
    a = x.detach().clone().requires_grad_()
    (pmesh.psum(a, group) * w).sum().backward()
    res["psum_grad"] = a.grad.clone()
    # psum_replicated: every rank computes one loss -> the cotangent as it is
    b = x.detach().clone().requires_grad_()
    s = pmesh.psum_replicated(b, group)
    (s * s).sum().backward()
    res["psum_replicated"] = (s.detach(), b.grad.clone())
    # share_input: each rank uses its own part -> the cotangents summed
    c = torch.from_numpy(_stacked(2)[0]).requires_grad_()
    (pmesh.share_input(c, group) * w).sum().backward()
    res["share_input_grad"] = c.grad.clone()
    # all_gather along dim 1: every rank then computes one loss
    d = x.detach().clone().requires_grad_()
    full = pmesh.all_gather(d, group, 1)
    (full * full).sum().backward()
    res["all_gather"] = (full.detach(), d.grad.clone())
    return res


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    return run_world(_mesh_body, 4, tmp_path_factory.mktemp("mesh"))


def test_mesh_shapes_and_sharding(mesh_world):
    for rank, res in enumerate(mesh_world):
        assert res["1d"] == (("data",), 4, rank)
        assert res["2d"] == (("data", "model"), 2, 2, rank // 2, rank % 2)
        assert res["pipe"] == (("data", "pipe"), rank % 2)
        assert "needs 3 processes" in res["bad"]
        np.testing.assert_array_equal(res["rows"]["x"].numpy().ravel(), [2 * rank, 2 * rank + 1])
        np.testing.assert_array_equal(res["rows"]["y"][0].numpy(), [2 * rank, 2 * rank + 1])
        np.testing.assert_array_equal(res["bcast"].numpy(), [0.0, 0.0])


def test_ppermute_forward_and_backward_are_rolls(mesh_world):
    """Rank r receives rank r - 1's x (a roll of the stacked tensor by one);
    its x's cotangent comes back from rank r + 1 (the reversed ring)."""
    x, w = _stacked(), _stacked(1)
    for shift, key in ((1, "ppermute"), (-1, "ppermute_back")):
        y = np.stack([r[key][0].numpy() for r in mesh_world])
        g = np.stack([r[key][1].numpy() for r in mesh_world])
        np.testing.assert_array_equal(y, np.roll(x, shift, axis=0))
        np.testing.assert_array_equal(g, np.roll(w, -shift, axis=0))


def test_collective_transposes(mesh_world):
    x, w, c = _stacked(), _stacked(1), _stacked(2)[0]
    s = x.sum(axis=0)
    for rank, res in enumerate(mesh_world):
        np.testing.assert_allclose(res["psum_grad"].numpy(), w.sum(axis=0), rtol=1e-6)
        np.testing.assert_allclose(res["psum_replicated"][0].numpy(), s, rtol=1e-6)
        np.testing.assert_allclose(res["psum_replicated"][1].numpy(), 2 * s, rtol=1e-6)
        np.testing.assert_allclose(res["share_input_grad"].numpy(), w.sum(axis=0), rtol=1e-6)
        np.testing.assert_array_equal(res["all_gather"][0].numpy(), np.concatenate(x, axis=1))
        np.testing.assert_array_equal(res["all_gather"][1].numpy(), 2 * x[rank])


# ---------------------------------------------------------------------------
# maybe_initialize_distributed: JAX's three behaviours (no world needed)
# ---------------------------------------------------------------------------
@pytest.fixture
def no_world(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    calls = []
    monkeypatch.setattr(pmesh.dist, "is_initialized", lambda: False)
    return calls


def test_distributed_init_is_a_noop_unconfigured(no_world, monkeypatch):
    monkeypatch.setattr(pmesh.dist, "init_process_group",
                        lambda *a, **k: no_world.append((a, k)))
    assert pmesh.maybe_initialize_distributed(Config(), device="cpu") is False
    assert no_world == []


def test_distributed_requested_but_failing_raises(no_world, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no rendezvous")

    monkeypatch.setattr(pmesh.dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="Config.distributed"):
        pmesh.maybe_initialize_distributed(Config(distributed=True), device="cpu")


def test_env_var_opportunistic_init_falls_back(no_world, monkeypatch, capsys):
    def boom(*a, **k):
        raise ValueError("MASTER_ADDR expected")

    monkeypatch.setattr(pmesh.dist, "init_process_group", boom)
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert pmesh.maybe_initialize_distributed(Config(), device="cpu") is False
    assert "init_process_group skipped" in capsys.readouterr().out


def test_distributed_init_before_dataset(tmp_path, monkeypatch):
    """The Trainer joins the group before it places any tensor (build_dataset
    comes second), with the backend of the device it was given."""
    from pose_estimation_amitai_torch.data import make_synthetic_arrays
    from pose_estimation_amitai_torch.train import trainer as trainer_mod

    events = []

    class Placed(Exception):
        pass

    def spy(cfg, arrays=None, **kw):  # the first tensor the Trainer places
        events.append("build_dataset")
        raise Placed

    monkeypatch.setattr(trainer_mod, "maybe_initialize_distributed",
                        lambda cfg, device: events.append(("dist", pmesh.backend_for(device))))
    monkeypatch.setattr(trainer_mod, "build_dataset", spy)
    arrays = make_synthetic_arrays(num_frames=4, num_points=6, image_size=48, seed=0)
    cfg = Config(epochs=1, batch_size=4, batches_per_epoch=1, num_base_filters=8,
                 base_output_path=str(tmp_path), val_fraction=0.5, distributed=True)
    with pytest.raises(Placed):
        trainer_mod.Trainer(cfg, arrays=arrays, device="cpu")
    assert events == [("dist", "gloo"), "build_dataset"], events


# ---------------------------------------------------------------------------
# Predictor(mesh=): the body of tests/test_torch_infer.py's serving case
# ---------------------------------------------------------------------------
def serve_body(rank, world, cfg, params, frames, shape, k, chunk_size):
    """One Predictor(mesh=) per rank on the module route: its peaks, its
    maps and peaks with ``return_heatmaps``, and a ``predict_movie``; and
    what the first Predictor's stager was given and gave in its call and its
    movie, (rows in, staged chunk) a chunk."""
    from pose_estimation_amitai_torch.infer import Predictor

    mesh = pmesh.make_mesh((), "cpu")
    pred = Predictor(cfg, params, shape, k, device="cpu", chunk_size=chunk_size, mesh=mesh)
    stager, staged = pred._stager, []

    def spy(chunk):
        out = stager(chunk)
        staged.append((chunk.shape[0], out.clone()))
        return out

    pred._stager = spy
    maps, pts = Predictor(cfg, params, shape, k, device="cpu", chunk_size=chunk_size,
                          return_heatmaps=True, mesh=mesh)(frames)
    return {"path": pred.serving_path, "pts": pred(frames), "staged": staged, "maps": maps,
            "maps_pts": pts, "movie": pred.predict_movie(frames)}
