"""The port's Predictor vs the JAX Predictor on its default flax route
(compute_dtype float32), for all three decodes on both port routes, for the
flagship BasicNet, for the two ViT families, and for the BatchNorm and
camera-matrix families (``batch_stats``, ``cameras``), plus the
flax-checkpoint reader and ``mesh`` serving in a 2-rank gloo world (the
int8 routes are in tests/test_torch_quantized.py).

Chunk 2 over 5 frames, so the last chunk is zero-padded and its padded row
dropped. The JAX fused route has no interpret switch, so it cannot run on
the CPU; the port's fused route runs its kernels' plain versions here."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch import infer as tinfer
from pose_estimation_amitai_torch import weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_tpu import infer as jinfer
from pose_estimation_amitai_tpu.train import checkpoint as jckpt

from test_torch_resnet import one_thread  # noqa: F401 (a fixture)

SHAPE = (48, 48, 4)
K = 6
CFG = Config(num_base_filters=8, compute_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    frames = rng.random((5, *SHAPE)).astype(np.float32)
    params = weights.init_basicnet_params(rng, SHAPE[-1], K, filters=8)
    return frames, params


@pytest.fixture(scope="module")
def jax_results(setup):
    frames, params = setup
    out = {}
    for decode in tinfer.DECODES:
        pred = jinfer.Predictor(
            CFG, jax.tree_util.tree_map(jnp.asarray, params), SHAPE, K,
            chunk_size=2, return_heatmaps=True, decode=decode,
        )
        assert pred.serving_path == "flax"
        maps, pts = pred(frames)
        out[decode] = (np.asarray(maps), np.asarray(pts))
    return out


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("decode", tinfer.DECODES)
def test_predictor_matches_jax(setup, jax_results, decode, use_fused):
    frames, params = setup
    pred = tinfer.Predictor(CFG, params, SHAPE, K, device="cpu", chunk_size=2,
                            return_heatmaps=True, decode=decode,
                            use_fused=use_fused)
    assert pred.serving_path == ("fused" if use_fused else "module")
    maps, pts = pred(frames)
    want_maps, want_pts = jax_results[decode]
    assert maps.shape == want_maps.shape == (5, *SHAPE[:2], K)
    assert pts.shape == want_pts.shape == (5, 3, K)
    np.testing.assert_allclose(maps, want_maps, atol=2e-5)
    if decode == "argmax":
        np.testing.assert_array_equal(pts[:, :2], want_pts[:, :2])
        np.testing.assert_allclose(pts[:, 2], want_pts[:, 2], atol=2e-5)
    else:
        np.testing.assert_allclose(pts, want_pts, atol=1e-4)


@pytest.mark.parametrize("dilation", [1, 2, 3])
def test_use_fused_routes_as_jax(setup, dilation):
    """use_fused serves through the kernels only at the flagship geometry
    (kernel 3, dilation 2), as JAX's Predictor does; other dilations take
    the module route, and agree with JAX's flax route."""
    frames, params = setup
    cfg = CFG.replace(dilation_rate=dilation)
    want = jinfer.Predictor(cfg, jax.tree_util.tree_map(jnp.asarray, params),
                            SHAPE, K, chunk_size=2, return_heatmaps=True,
                            use_fused=True)
    pred = tinfer.Predictor(cfg, params, SHAPE, K, device="cpu", chunk_size=2,
                            return_heatmaps=True, use_fused=True)
    assert (want.serving_path, pred.serving_path) == (
        ("fused", "fused") if dilation == 2 else ("flax", "module"))
    assert (pred.model is None) == (dilation == 2)
    if dilation != 2:  # the JAX fused route cannot run on the CPU
        np.testing.assert_allclose(pred(frames)[0], np.asarray(want(frames)[0]),
                                   atol=2e-5)


def test_predict_movie_and_peaks_only(setup):
    frames, params = setup
    pred = tinfer.Predictor(CFG, params, SHAPE, K, device="cpu", chunk_size=2,
                            use_fused=True)
    pts = pred(frames)
    assert pts.shape == (5, 3, K)
    np.testing.assert_array_equal(pred.predict_movie(frames, prefetch=2), pts)
    np.testing.assert_array_equal(pred(frames[:1]), pts[:1])
    assert pred.predict_movie(frames[:0]).shape == (0, 3, K)
    with pytest.raises(ValueError, match="peaks only"):
        tinfer.Predictor(CFG, params, SHAPE, K, device="cpu",
                         return_heatmaps=True).predict_movie(frames)


MOVIE_CHUNK = 2
MOVIE_LENGTHS = (0, MOVIE_CHUNK - 1, MOVIE_CHUNK, 3 * MOVIE_CHUNK + 1)


def _movie(length: int, dtype: str) -> np.ndarray:
    rng = np.random.default_rng(length)
    if dtype == "uint8":
        return rng.integers(0, 256, (length, *SHAPE), dtype=np.uint8)
    return rng.random((length, *SHAPE), dtype=np.float32)


def _spy_on_run(pred, staged: list, chunk_of) -> None:
    """Record ``chunk_of(args)``, the chunk of each ``pred._run(*args)`` as
    numpy (JAX's ``_run`` is an attribute its constructor sets; the port's
    a method, shadowed here)."""
    run = pred._run

    def spy(*args):
        staged.append(chunk_of(args))
        return run(*args)

    pred._run = spy


@pytest.fixture(scope="module")
def jax_movies(setup):
    """JAX's predict_movie of each length and dtype: (its staged chunks,
    its peaks)."""
    _, params = setup
    pred = jinfer.Predictor(CFG, jax.tree_util.tree_map(jnp.asarray, params), SHAPE, K,
                            chunk_size=MOVIE_CHUNK)
    staged: list = []
    _spy_on_run(pred, staged, lambda a: np.asarray(a[1]))  # a[0]: variables
    out = {}
    for length in MOVIE_LENGTHS:
        for dtype in ("float32", "uint8"):
            staged.clear()
            pts = np.asarray(pred.predict_movie(_movie(length, dtype), prefetch=2))
            out[length, dtype] = (list(staged), pts)
    return out


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("prefetch", [1, 2, 4])
@pytest.mark.parametrize("length", MOVIE_LENGTHS)
def test_predict_movie_stages_as_jax(setup, jax_movies, length, prefetch, dtype, kind):
    """predict_movie through the stager against JAX's: every chunk reaches
    the model bit for bit as JAX stages it (the frames' own dtype, the tail
    zero-padded); peak positions bit for bit, vals within 2e-5 of the maps'
    scale (oneDNN and XLA sum the convs in other orders); and bit for bit
    the port's own chunk-by-chunk __call__ on the same frames."""
    _, params = setup
    want_staged, want = jax_movies[length, dtype]
    frames = _movie(length, dtype)
    if kind == "tensor":
        frames = torch.from_numpy(frames)
    pred = tinfer.Predictor(CFG, params, SHAPE, K, device="cpu", chunk_size=MOVIE_CHUNK)
    staged: list = []
    _spy_on_run(pred, staged, lambda a: a[0].numpy().copy())
    got = pred.predict_movie(frames, prefetch=prefetch)
    assert len(staged) == len(want_staged) == -(-length // MOVIE_CHUNK)
    for a, b in zip(staged, want_staged):
        assert a.dtype == b.dtype == np.dtype(dtype) and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if length == 0:  # JAX returns (0, 3, 1) here (ROADMAP, "Differences from JAX")
        assert got.shape == (0, 3, K) and want.size == 0
        return
    assert got.shape == want.shape == (length, 3, K) and got.dtype == want.dtype
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2], want[:, 2],
                               atol=2e-5 * max(1.0, float(np.abs(want[:, 2]).max())))
    np.testing.assert_array_equal(got, pred(frames))


def test_bf16_fused_close_to_module(setup):
    """bf16 compute on the CPU: the two routes round at other places, so
    they agree to bf16 precision, not exactly."""
    frames, params = setup
    cfg = Config(num_base_filters=8)
    outs = [tinfer.Predictor(cfg, params, SHAPE, K, device="cpu", use_fused=f,
                             return_heatmaps=True)(frames)[0] for f in (False, True)]
    np.testing.assert_allclose(outs[1], outs[0], atol=3e-2 * np.abs(outs[0]).max())


@pytest.mark.parametrize("kind", ["params", "full", "bf16"])
def test_load_flax_checkpoint_round_trip(tmp_path, setup, kind):
    frames, params = setup
    path = str(tmp_path / "ckpt.msgpack")
    want = params
    if kind == "params":
        jckpt.save_params(path, jax.tree_util.tree_map(jnp.asarray, params))
    elif kind == "full":
        payload = {"step": np.int32(7), "params": params,
                   "opt_state": {"mu": params, "count": np.int32(7)},
                   "batch_stats": {}, "rng": np.arange(2, dtype=np.uint32)}
        with open(path, "wb") as f:
            f.write(serialization.to_bytes(payload))
    else:
        bf = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.bfloat16), params)
        jckpt.save_params(path, bf)
        want = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), bf)
    got, batch_stats = weights.load_flax_checkpoint(path)
    assert batch_stats == {}
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    pred = tinfer.Predictor.from_checkpoint(CFG, path, SHAPE, K, device="cpu",
                                            chunk_size=2)
    ref = tinfer.Predictor(CFG, want, SHAPE, K, device="cpu", chunk_size=2)
    np.testing.assert_array_equal(pred(frames), ref(frames))


@pytest.mark.parametrize("files, wins", [
    (("checkpoint.msgpack",), "checkpoint.msgpack"),
    (("checkpoint.msgpack", "best_model.msgpack"), "best_model.msgpack"),
])
def test_load_flax_checkpoint_from_run_directory(tmp_path, setup, files, wins):
    """A run directory, as the JAX ``load_variables`` takes one: the best
    snapshot if there, else the training checkpoint."""
    frames, params = setup
    trees = {}
    for i, name in enumerate(files):
        trees[name] = jax.tree_util.tree_map(lambda v: np.asarray(v) * (1.0 + i), params)
        if name == "checkpoint.msgpack":
            payload = {"step": np.int32(3), "params": trees[name],
                       "opt_state": {"count": np.int32(3)}, "batch_stats": {},
                       "rng": np.arange(2, dtype=np.uint32)}
            (tmp_path / name).write_bytes(serialization.to_bytes(payload))
        else:
            jckpt.save_params(str(tmp_path / name),
                              jax.tree_util.tree_map(jnp.asarray, trees[name]))
    got, batch_stats = weights.load_flax_checkpoint(str(tmp_path))
    assert batch_stats == {}
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(trees[wins])):
        np.testing.assert_array_equal(a, b)
    jax_params, _ = jckpt.load_variables(str(tmp_path))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jax_params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    pred = tinfer.Predictor.from_checkpoint(CFG, str(tmp_path), SHAPE, K, device="cpu",
                                            chunk_size=2)
    ref = tinfer.Predictor(CFG, trees[wins], SHAPE, K, device="cpu", chunk_size=2)
    np.testing.assert_array_equal(pred(frames), ref(frames))


def test_load_flax_checkpoint_from_an_empty_run_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match="best_model.msgpack.*checkpoint.msgpack"):
        weights.load_flax_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tinfer.Predictor.from_checkpoint(CFG, str(tmp_path), SHAPE, K, device="cpu")


def _block_msgpack(monkeypatch):
    """Make ``import msgpack`` raise, as on a machine without it."""
    import sys

    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError):
        import msgpack  # noqa: F401


@pytest.mark.parametrize("target", ["run_dir", "checkpoint.pt", "snapshot"])
def test_from_checkpoint_serves_the_ports_own_checkpoints(tmp_path, setup, monkeypatch,
                                                         target):
    """C3: the port's trainer writes torch.save files (best_model.pt,
    checkpoint.pt, save_params snapshots); from_checkpoint serves them, with
    msgpack unimportable, through the weight bridge, equal to a Predictor
    built from the same parameters in memory."""
    from pose_estimation_amitai_torch.models import build_model
    from pose_estimation_amitai_torch.train import checkpoint as tckpt
    from pose_estimation_amitai_torch.train import loop as tloop

    frames, _ = setup
    _block_msgpack(monkeypatch)
    model = build_model(CFG, SHAPE, K)
    state = tloop.create_train_state(model, CFG, seed=4, device="cpu")
    best = state.replace(params={k: v + 0.01 for k, v in state.params.items()})
    tckpt.save_checkpoint(str(tmp_path), state, epoch=0, val_loss=1.0)
    tckpt.save_checkpoint(str(tmp_path), best, epoch=0, val_loss=0.5, best=True)
    tckpt.save_params(str(tmp_path / "weights.001-0.5.pt"), state.params)
    path, params = {"run_dir": (str(tmp_path), best.params),
                    "checkpoint.pt": (str(tmp_path / "checkpoint.pt"), state.params),
                    "snapshot": (str(tmp_path / "weights.001-0.5.pt"), state.params)}[target]
    pred = tinfer.Predictor.from_checkpoint(CFG, path, SHAPE, K, device="cpu", chunk_size=2,
                                            return_heatmaps=True)
    ref = tinfer.Predictor(CFG, weights.state_dict_to_flax(params), SHAPE, K, device="cpu",
                           chunk_size=2, return_heatmaps=True)
    for a, b in zip(pred(frames), ref(frames)):
        np.testing.assert_array_equal(a, b)


def test_from_checkpoint_prefers_pt_and_names_all_four(tmp_path, setup, monkeypatch):
    """The reader is picked by what is on disk, the port's .pt files first;
    a run directory with none of the four names raises naming them all."""
    from pose_estimation_amitai_torch.train import checkpoint as tckpt

    frames, params = setup
    sd = weights.basicnet_state_dict(params)
    jckpt.save_params(str(tmp_path / "best_model.msgpack"),
                      jax.tree_util.tree_map(lambda v: jnp.asarray(v) * 2.0, params))
    tckpt.save_params(str(tmp_path / "checkpoint.pt"), sd)
    _block_msgpack(monkeypatch)
    got, stats = weights.load_checkpoint(str(tmp_path))
    assert stats == {}
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="best_model.pt, checkpoint.pt, "
                                                "best_model.msgpack, checkpoint.msgpack"):
        tinfer.Predictor.from_checkpoint(CFG, str(empty), SHAPE, K, device="cpu")
    # a msgpack file, named, is read by the port's own msgpack reader
    got, _ = weights.load_checkpoint(str(tmp_path / "best_model.msgpack"))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b) * 2.0)


@pytest.mark.parametrize("model_type, cin, k", [
    (C.ALL_CAMS_18_POINTS, 16, 12), (C.TWO_WINGS_TOGATHER, 5, 8), (C.C2F_PER_WING, 4, 6)])
def test_cnn_family_serves_on_module_and_matches_jax(model_type, cin, k):
    """The CNN family serves on "module" whatever use_fused says (JAX fuses
    the flagship only); maps and peaks as JAX's Predictor gives them; int8
    serving takes the "int8_generic" route."""
    from pose_estimation_amitai_torch.models import build_model
    from pose_estimation_amitai_torch.train import loop as tloop

    cfg = Config(model_type=model_type, num_base_filters=8, compute_dtype="float32",
                 arch_flavor="tf" if model_type == C.C2F_PER_WING else "torch")
    shape = (48, 48, cin)
    state = tloop.create_train_state(build_model(cfg, shape, k), cfg, seed=5, device="cpu")
    params = weights.state_dict_to_flax(
        {n: v + 0.05 if n.endswith("bias") else v for n, v in state.params.items()})
    frames = np.random.default_rng(1).random((3, *shape)).astype(np.float32)
    want_maps, want_pts = jinfer.Predictor(
        cfg, jax.tree_util.tree_map(jnp.asarray, params), shape, k, chunk_size=2,
        return_heatmaps=True)(frames)
    pred = tinfer.Predictor(cfg, params, shape, k, device="cpu", chunk_size=2,
                            use_fused=True, return_heatmaps=True)
    assert pred.serving_path == "module"
    maps, pts = pred(frames)
    np.testing.assert_allclose(maps, np.asarray(want_maps), atol=2e-5)
    np.testing.assert_array_equal(pts[:, :2], np.asarray(want_pts)[:, :2])
    qpred = tinfer.Predictor(cfg, params, shape, k, device="cpu", use_quantized=True,
                             calibration_frames=frames, use_fused=True)
    assert qpred.serving_path == "int8_generic"


@pytest.mark.parametrize("model_type, cin, k", [
    (C.RESNET_18_POINTS_PER_WING, 4, 6), (C.GPTNET, 4, 6),
    (C.ALL_CAMS_DISENTANGLED_PER_WING_CNN, 16, 24)])
def test_batchnorm_and_camera_families_serve_as_jax(model_type, cin, k, one_thread):
    """``batch_stats`` (a flax tree, as JAX's Predictor takes it) and, for
    the disentangled model, ``cameras`` one row per sample: the maps and
    peaks of JAX's Predictor on the same variables, 3 samples in chunks of
    2 (the tail padded, its camera row repeated); on "module" whatever
    use_fused says."""
    from pose_estimation_amitai_torch.models import build_model
    from pose_estimation_amitai_torch.train import loop as tloop

    cfg = Config(model_type=model_type, num_base_filters=8, compute_dtype="float32")
    shape = (48, 48, cin)
    model = build_model(cfg, shape, k)
    state = tloop.create_train_state(model, cfg, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(6)
    params = weights.state_dict_to_flax(
        {n: v + 0.05 * torch.randn(v.shape, generator=gen) if v.dim() == 1 else v
         for n, v in state.params.items()}, model)
    stats = weights.batch_stats_to_flax(
        {n: 0.5 + torch.rand(v.shape, generator=gen) if n.endswith("var") else
         0.1 * torch.randn(v.shape, generator=gen) for n, v in state.batch_stats.items()})
    rng = np.random.default_rng(1)
    frames = rng.random((3, *shape)).astype(np.float32)
    cams = None
    if cin == 16:
        P = rng.standard_normal((3, 4, 3, 4)).astype(np.float32)
        cams = (P, np.linalg.pinv(P).astype(np.float32))
    jtree = jax.tree_util.tree_map(jnp.asarray, params)
    jstats = jax.tree_util.tree_map(jnp.asarray, stats)
    want_maps, want_pts = jinfer.Predictor(
        cfg, jtree, shape, k, chunk_size=2, return_heatmaps=True, batch_stats=jstats,
        cameras=cams)(frames)
    pred = tinfer.Predictor(cfg, params, shape, k, device="cpu", chunk_size=2, use_fused=True,
                            return_heatmaps=True, batch_stats=stats, cameras=cams)
    assert pred.serving_path == "module"
    maps, pts = pred(frames)
    np.testing.assert_allclose(maps, np.asarray(want_maps), atol=2e-5)
    np.testing.assert_array_equal(pts[:, :2], np.asarray(want_pts)[:, :2])
    movie = tinfer.Predictor(cfg, params, shape, k, device="cpu", chunk_size=2,
                             batch_stats=stats, cameras=cams).predict_movie(frames)
    np.testing.assert_array_equal(movie, pts)
    with pytest.raises(ValueError, match="running_mean"):  # a BatchNorm model needs them
        tinfer.Predictor(cfg, params, shape, k, device="cpu", cameras=cams)


def test_evaluate_l2_matches_jax(setup):
    frames, params = setup
    maps = np.random.default_rng(7).random((5, *SHAPE[:2], K)).astype(np.float32)
    got = tinfer.evaluate_l2(tinfer.Predictor(CFG, params, SHAPE, K, device="cpu",
                                              chunk_size=2), frames, maps)
    want = jinfer.evaluate_l2(jinfer.Predictor(
        CFG, jax.tree_util.tree_map(jnp.asarray, params), SHAPE, K, chunk_size=2),
        frames, maps)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


@pytest.fixture(scope="module")
def mesh_ranks(setup, tmp_path_factory):
    """What each rank of a 2-rank gloo world returns from ``serve_body``
    (tests/test_torch_parallel_mesh.py), chunk 2 over the 5 frames."""
    from test_torch_parallel_mesh import run_world, serve_body

    frames, params = setup
    return run_world(serve_body, 2, tmp_path_factory.mktemp("mesh_serving"), CFG, params,
                     frames, SHAPE, K, 2)


@pytest.mark.parametrize("kw, item", [({"mesh": 2}, "item 14")])
def test_unported_options_raise(setup, mesh_ranks, kw, item):
    """``mesh`` (ROADMAP Queue A item 14) is ported: a 2-rank gloo world
    serves the flagship on the module route, each rank its rows of every
    chunk, and every rank returns the whole answer, equal to the mesh-less
    Predictor's on the same rows; a chunk that does not divide over the
    mesh is refused."""
    frames, params = setup
    ranks = mesh_ranks
    assert len(ranks) == kw["mesh"]
    # each rank runs one row of each 2-frame chunk: the same convolutions
    # (oneDNN blocks by batch size) as a mesh-less chunk of 1
    plain = tinfer.Predictor(CFG, params, SHAPE, K, device="cpu", chunk_size=1,
                             return_heatmaps=True)
    maps, pts = plain(frames)
    for res in ranks:
        assert res["path"] == "module"
        np.testing.assert_array_equal(res["maps"], maps)
        np.testing.assert_array_equal(res["maps_pts"], pts)
        np.testing.assert_array_equal(res["pts"], pts)
        np.testing.assert_array_equal(res["movie"], pts)

    class TwoRanks:
        def size(self):
            return 2

    with pytest.raises(ValueError, match="chunk_size=3 must divide"):
        tinfer.Predictor(CFG, params, SHAPE, K, device="cpu", chunk_size=3, mesh=TwoRanks())


def test_mesh_stages_only_its_rows(setup, mesh_ranks):
    """Each rank of the 2-rank world stages its own row of every 2-frame
    chunk, as JAX's batch-sharded ``device_put`` places it, in the call and
    in the movie: one row in (none for rank 1's share of the padded tail),
    one row out, a zero row where the tail is padding; the answer is the
    mesh-less one (the test above)."""
    frames, _ = setup
    for rank, res in enumerate(mesh_ranks):
        rows_in = [n for n, _ in res["staged"]]
        assert rows_in == ([1, 1, 1] if rank == 0 else [1, 1, 0]) * 2
        for i, (n, t) in enumerate(res["staged"]):
            assert t.shape == (1, *SHAPE)
            row = 2 * (i % 3) + rank
            want = frames[row : row + 1] if n else np.zeros((1, *SHAPE))
            np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("case", ["basicnet_dilation1", "gptnet", "disentangled"])
def test_int8_generic_serves_off_the_flagship(case, one_thread):
    """use_quantized off the flagship geometry serves on "int8_generic", as
    JAX routes it: a BasicNet at dilation 1, the BatchNorm family
    (GPTResNet, its running averages) and the camera model (its cameras);
    one call decodes finite peaks inside the frame."""
    from pose_estimation_amitai_torch.models import build_model
    from pose_estimation_amitai_torch.train import loop as tloop

    cfg, cin, k = {
        "basicnet_dilation1": (CFG.replace(dilation_rate=1), 4, K),
        "gptnet": (Config(model_type=C.GPTNET), 4, K),
        "disentangled": (Config(model_type=C.ALL_CAMS_DISENTANGLED_PER_WING_CNN,
                                num_base_filters=8), 16, 24),
    }[case]
    shape = (48, 48, cin)
    model = build_model(cfg, shape, k)
    state = tloop.create_train_state(model, cfg, seed=3, device="cpu")
    params = weights.state_dict_to_flax(state.params, model)
    stats = weights.batch_stats_to_flax(state.batch_stats) if state.batch_stats else None
    rng = np.random.default_rng(4)
    frames = rng.random((3, *shape)).astype(np.float32)
    cameras = None
    if case == "disentangled":
        P = rng.standard_normal((3, 4, 3, 4)).astype(np.float32)
        cameras = (P, np.linalg.pinv(P).astype(np.float32))
    pred = tinfer.Predictor(cfg, params, shape, k, device="cpu", chunk_size=2,
                            use_quantized=True, calibration_frames=frames,
                            batch_stats=stats, cameras=cameras)
    assert pred.serving_path == "int8_generic"
    pts = pred(frames)
    assert pts.shape == (3, 3, k) and np.isfinite(pts).all()
    assert ((pts[:, :2] >= 0) & (pts[:, :2] < 48)).all()


def test_device_is_required_and_decode_checked(setup):
    _, params = setup
    with pytest.raises(TypeError):
        tinfer.Predictor(CFG, params, SHAPE, K)
    with pytest.raises(ValueError, match="decode"):
        tinfer.Predictor(CFG, params, SHAPE, K, device="cpu", decode="median")


# ---------------------------------------------------------------------------
# ViT families
# ---------------------------------------------------------------------------
VIT = {
    "single": dict(
        cfg=Config(model_type=C.MODEL_18_POINTS_PER_WING_VIT, projection_dim=64,
                   num_heads=2, transformer_layers=2, fully_connected_expand=2,
                   compute_dtype="float32"),
        shape=(48, 48, 4), k=6, four=False),
    "four": dict(
        cfg=Config(model_type=C.ALL_CAMS_18_POINTS_VIT, projection_dim=32,
                   num_heads=2, transformer_layers=1, fully_connected_expand=2,
                   compute_dtype="float32"),
        shape=(48, 48, 16), k=8, four=True),
}


@pytest.fixture(scope="module")
def vit_setup():
    out = {}
    for kind, v in VIT.items():
        rng = np.random.default_rng(7)
        cfg = v["cfg"]
        params = weights.init_vit_params(
            rng, v["shape"][-1], v["k"], 48, dim=cfg.projection_dim,
            depth=cfg.transformer_layers, heads=cfg.num_heads,
            dim_head=cfg.projection_dim, mlp_expand=2, four_cameras=v["four"])
        frames = rng.standard_normal((5, *v["shape"])).astype(np.float32)
        out[kind] = (frames, params)
    return out


def _jax_vit(kind, params, **kw):
    v = VIT[kind]
    return jinfer.Predictor(v["cfg"], jax.tree_util.tree_map(jnp.asarray, params),
                            v["shape"], v["k"], chunk_size=2, **kw)


def _port_vit(kind, params, **kw):
    v = VIT[kind]
    kw.setdefault("chunk_size", 2)
    return tinfer.Predictor(v["cfg"], params, v["shape"], v["k"], device="cpu", **kw)


@pytest.fixture(scope="module")
def vit_jax_results(vit_setup):
    out = {}
    for kind, (frames, params) in vit_setup.items():
        for decode in tinfer.DECODES:
            pred = _jax_vit(kind, params, return_heatmaps=True, decode=decode)
            assert pred.serving_path == "flax" and pred.model.fast_softmax is False
            maps, pts = pred(frames)
            out[kind, decode] = (np.asarray(maps), np.asarray(pts))
    return out


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("decode", tinfer.DECODES)
@pytest.mark.parametrize("kind", list(VIT))
def test_vit_predictor_matches_jax(vit_setup, vit_jax_results, kind, decode, use_fused):
    """Normalised float32 maps and every decode, on both of the port's
    routes (on the CPU the fused route runs the attention kernel's plain
    version), against JAX's flax route."""
    frames, params = vit_setup[kind]
    pred = _port_vit(kind, params, return_heatmaps=True, decode=decode,
                     use_fused=use_fused)
    assert pred.serving_path == ("fused" if use_fused else "module")
    maps, pts = pred(frames)
    want_maps, want_pts = vit_jax_results[kind, decode]
    k = VIT[kind]["k"]
    assert maps.shape == want_maps.shape == (5, 48, 48, k)
    assert pts.shape == want_pts.shape == (5, 3, k)
    np.testing.assert_allclose(maps, want_maps, atol=1e-4)
    if decode == "argmax":
        np.testing.assert_array_equal(pts[:, :2], want_pts[:, :2])
        np.testing.assert_allclose(pts[:, 2], want_pts[:, 2], atol=1e-5)
    else:
        np.testing.assert_allclose(pts, want_pts, atol=2e-4)


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("kind", list(VIT))
def test_vit_peaks_only_val_renorm(vit_setup, vit_jax_results, kind, use_fused):
    """Argmax peaks-only serving skips the min-max normalisation and
    recovers the val channel from the raw maps' min and max: bit-equal to
    decoding the normalised maps, and equal to JAX's peaks-only answer."""
    frames, params = vit_setup[kind]
    pred = _port_vit(kind, params, use_fused=use_fused, fast_softmax=False)
    assert pred._val_renorm_views == (4 if kind == "four" else 1)
    assert pred.model.normalize_output is False
    pts = pred(frames)
    with_maps = _port_vit(kind, params, use_fused=use_fused, fast_softmax=False,
                          return_heatmaps=True)
    assert with_maps._val_renorm_views == 0 and with_maps.model.normalize_output
    np.testing.assert_array_equal(pts, with_maps(frames)[1])
    np.testing.assert_array_equal(pred.predict_movie(frames, prefetch=2), pts)
    want = np.asarray(_jax_vit(kind, params, fast_softmax=False)(frames))
    np.testing.assert_array_equal(pts[:, :2], want[:, :2])
    np.testing.assert_allclose(pts[:, 2], want[:, 2], atol=1e-5)
    np.testing.assert_allclose(pts[:, 2], vit_jax_results[kind, "argmax"][1][:, 2],
                               atol=1e-5)


def test_vit_fast_softmax_auto_rule(vit_setup):
    """JAX's rule: None engages the bf16 chain for argmax peaks-only
    serving; False and True force it; the fused route keeps it off."""
    _, params = vit_setup["single"]
    for kw, want in [
        ({}, True), ({"return_heatmaps": True}, False), ({"decode": "soft"}, False),
        ({"fast_softmax": False}, False),
        ({"fast_softmax": True, "return_heatmaps": True}, True),
        ({"use_fused": True}, False), ({"use_fused": True, "fast_softmax": False}, False),
    ]:
        pred = _port_vit("single", params, **kw)
        jkw = {k: v for k, v in kw.items() if k != "use_fused"}
        if "use_fused" not in kw:
            assert _jax_vit("single", params, **jkw).model.fast_softmax is want
        assert pred.model.fast_softmax is want, kw
        assert pred.model.transformer.attn0.fast_softmax is want
        assert pred.model.fused_attention is bool(kw.get("use_fused"))
    with pytest.raises(ValueError, match="fast_softmax=True excludes"):
        _port_vit("single", params, use_fused=True, fast_softmax=True)


def test_vit_fast_softmax_peaks_match_jax(vit_setup):
    """The default argmax peaks-only route (bf16 chain engaged, float32
    compute here): same peaks as JAX's default."""
    frames, params = vit_setup["single"]
    pts = _port_vit("single", params)(frames)
    want = np.asarray(_jax_vit("single", params)(frames))
    np.testing.assert_array_equal(pts[:, :2], want[:, :2])
    np.testing.assert_allclose(pts[:, 2], want[:, 2], atol=1e-5)


def test_vit4cam_views_unfold_from_chunk_128(vit_setup):
    _, params = vit_setup["four"]
    assert _port_vit("four", params).model.fold_views is True
    assert _port_vit("four", params, chunk_size=127).model.fold_views is True
    assert _port_vit("four", params, chunk_size=128).model.fold_views is False
    assert _jax_vit("four", params).model.fold_views is True


def test_vit_tf_flavour_serves_unnormalised(vit_setup):
    """The tf flavour has no min-max: no val renorm, float32 maps."""
    frames, _ = vit_setup["single"]
    cfg = VIT["single"]["cfg"].replace(arch_flavor="tf")
    params = weights.init_vit_params(np.random.default_rng(3), 4, 6, 48, dim=64, depth=2,
                                     heads=2, dim_head=64, mlp_expand=2, flavor="tf")
    pred = tinfer.Predictor(cfg, params, (48, 48, 4), 6, device="cpu", chunk_size=2,
                            fast_softmax=False)
    assert pred._val_renorm_views == 0 and pred.serving_path == "module"
    want = jinfer.Predictor(cfg, jax.tree_util.tree_map(jnp.asarray, params),
                            (48, 48, 4), 6, chunk_size=2, fast_softmax=False)
    got, ref = pred(frames), np.asarray(want(frames))
    np.testing.assert_array_equal(got[:, :2], ref[:, :2])
    np.testing.assert_allclose(got[:, 2], ref[:, 2], atol=1e-5)


def test_vit_refusals(vit_setup):
    """int8 serving of a ViT takes "int8_generic"; the pipeline-parallel
    layout (ROADMAP item 14, now ported) serves as the ViTPoseNet tree it
    stacks."""
    frames, params = vit_setup["single"]
    pred = _port_vit("single", params, use_quantized=True, calibration_frames=frames)
    assert pred.serving_path == "int8_generic"
    assert np.isfinite(pred(frames)).all()
    depth = VIT["single"]["cfg"].transformer_layers
    stacked = weights.vit_tree_to_pipeline(params, depth)
    np.testing.assert_array_equal(_port_vit("single", stacked)(frames),
                                  _port_vit("single", params)(frames))


@pytest.mark.parametrize("kind", list(VIT))
def test_vit_from_checkpoint(tmp_path, vit_setup, kind):
    frames, params = vit_setup[kind]
    v = VIT[kind]
    path = str(tmp_path / "vit.msgpack")
    jckpt.save_params(path, jax.tree_util.tree_map(jnp.asarray, params))
    pred = tinfer.Predictor.from_checkpoint(v["cfg"], path, v["shape"], v["k"],
                                            device="cpu", chunk_size=2, use_fused=True)
    assert pred.serving_path == "fused"
    ref = _port_vit(kind, params, use_fused=True)
    np.testing.assert_array_equal(pred(frames), ref(frames))
