"""Pipeline parallelism (parallel/pipeline.py) in gloo worlds on the CPU,
at a small ViT (48 px, patch 16, dim 32, depth 4, heads 2, dim_head 16,
MLP x2, 6 maps, float32):

* a 2-rank (data 1, pipe 2) world: the pipelined forward and every
  gradient (the staged blocks', the replicated embedding's, norm's and
  decoder's, the frames') against ``apply_sequential`` at 2 microbatches
  and at 4 (more than stages), within 1e-5 of each tensor's largest; the
  forward against JAX's ``PipelinedViT.apply`` on the same weights within
  1e-5; the stacks staged; invalid microbatch counts and depths refused;
* a 4-rank (data 2, pipe 2) world: the ``Trainer`` with
  ``pipeline_stages=2``, 2 epochs of 2 updates, its loss falling, a resume
  to a third epoch, the non-ViT and the indivisible batch refused, and
  its run directory served through ``Predictor.from_checkpoint`` equal to
  ``ViTPoseNet`` on the converted weights;

and the layout converters against JAX's, key for key."""

import numpy as np
import pytest
import torch

from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch import viz, weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.data import make_synthetic_arrays
from pose_estimation_amitai_torch.parallel.pipeline import (
    PipelinedViT,
    make_pipeline_mesh,
    pipeline_params_to_vit,
    vit_params_to_pipeline,
)

from test_torch_parallel_mesh import World

ARCH = dict(image_hw=48, in_channels=4, out_channels=6, patch_size=16, dim=32, depth=4,
            heads=2, dim_head=16, mlp_expand=2)
ROWS = 4  # frames of the forward


def _frames() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(1)
    return (rng.standard_normal((ROWS, 48, 48, 4)).astype(np.float32),
            rng.standard_normal((ROWS, 48, 48, 6)).astype(np.float32))


def _grads(pipe, params: dict, x: np.ndarray, w: np.ndarray, sequential: bool):
    live = {k: v.clone().requires_grad_() for k, v in params.items()}
    xx = torch.from_numpy(x).requires_grad_()
    out = (pipe.apply_sequential if sequential else pipe.apply)(live, xx)
    (out * torch.from_numpy(w)).sum().backward()
    return (out.detach().numpy(), {k: v.grad.numpy() for k, v in live.items()},
            xx.grad.numpy())


def _pipe_body(rank, world, params: dict):
    mesh = make_pipeline_mesh(1, 2, "cpu")
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    x, w = _frames()
    res = {}
    for M in (2, 4):
        pipe = PipelinedViT(mesh, num_microbatches=M, dtype=torch.float32, **ARCH)
        local = pipe.shard_params(full)
        res[M] = _grads(pipe, local, x, w, sequential=False)
    res["sequential"] = _grads(pipe, full, x, w, sequential=True)
    res["staged"] = {k: tuple(v.shape) for k, v in local.items()}
    refused = []
    for kw in (dict(num_microbatches=0), dict(ARCH, depth=3)):
        try:
            PipelinedViT(mesh, **{**ARCH, **kw})
        except ValueError as e:
            refused.append(str(e))
    try:
        PipelinedViT(mesh, num_microbatches=2, **ARCH).apply(local, torch.zeros(3, 48, 48, 4))
    except ValueError as e:
        refused.append(str(e))
    res["refused"] = refused
    return res


@pytest.fixture(scope="module")
def jax_tree():
    """JAX's PipelinedViT on a (data 1, pipe 2) mesh and a seeded tree in its
    layout (a ViTPoseNet tree with nonzero biases, its blocks stacked)."""
    import jax.numpy as jnp
    from pose_estimation_amitai_tpu.parallel import pipeline as jpipeline

    mesh = jpipeline.make_pipeline_mesh(1, 2)
    pipe = jpipeline.PipelinedViT(mesh, num_microbatches=2, dtype=jnp.float32, **ARCH)
    vit = weights.init_vit_params(np.random.default_rng(0), 4, 6, 48, patch_size=16, dim=32,
                                  depth=4, heads=2, dim_head=16, mlp_expand=2)
    return pipe, weights.vit_tree_to_pipeline(vit, 4)


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_tree):
    """Started before JAX's forward compiles."""
    params = {k: v.numpy() for k, v in weights.pipeline_flax_to_state_dict(jax_tree[1]).items()}
    return World(_pipe_body, 2, tmp_path_factory.mktemp("pipe"), params)


@pytest.fixture(scope="module")
def jax_pipeline(jax_tree, world):
    """JAX's forward of the frames at 2 microbatches."""
    import jax
    import jax.numpy as jnp

    pipe, tree = jax_tree
    out = jax.jit(pipe.apply)(jax.tree_util.tree_map(jnp.asarray, tree),
                              jnp.asarray(_frames()[0]))
    return tree, np.asarray(out)


@pytest.fixture(scope="module")
def pipe_world(world, jax_pipeline):
    return world.results()


def _close(got: np.ndarray, want: np.ndarray, what: str, rtol: float = 1e-5):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)


def test_pipeline_forward_and_grads_match_sequential(pipe_world):
    for M in (2, 4):
        for rank, res in enumerate(pipe_world):
            out, grads, gx = res[M]
            want_out, want_grads, want_gx = res["sequential"]
            _close(out, want_out, f"M={M} out")
            _close(gx, want_gx, f"M={M} frames")
            for k, g in grads.items():
                want = want_grads[k]
                if k.startswith("blocks."):  # this stage's rows of the stack
                    want = want[2 * rank : 2 * rank + 2]
                _close(g, want, f"M={M} rank {rank} {k}")


def test_pipeline_apply_matches_jax(pipe_world, jax_pipeline):
    _, want = jax_pipeline
    for res in pipe_world:
        _close(res[2][0], want, "pipelined maps vs JAX")


def test_block_stacks_are_staged_and_bad_counts_refused(pipe_world):
    res = pipe_world[0]
    assert res["staged"]["blocks.attn.to_qkv.weight"] == (2, 96, 32)
    assert res["staged"]["embed.proj.weight"] == (32, 4, 16, 16)
    assert "num_microbatches must be >= 1" in res["refused"][0]
    assert "depth 3 must divide into 2" in res["refused"][1]
    assert "batch 3 must divide into 2 microbatches" in res["refused"][2]


def test_layout_converters_match_jax(jax_pipeline):
    import jax
    from pose_estimation_amitai_tpu.parallel import pipeline as jpipeline

    tree, _ = jax_pipeline
    vit = weights.pipeline_tree_to_vit(tree)
    want = jax.tree_util.tree_map(np.asarray, jpipeline.pipeline_params_to_vit(tree))
    _equal_trees(vit, want)
    _equal_trees(weights.vit_tree_to_pipeline(vit, 4),
                 jax.tree_util.tree_map(np.asarray, jpipeline.vit_params_to_pipeline(want, 4)))
    _equal_trees(vit_params_to_pipeline(pipeline_params_to_vit(tree), 4), tree)
    sd = weights.pipeline_flax_to_state_dict(tree)
    back = vit_params_to_pipeline(pipeline_params_to_vit(sd), 4)
    assert list(back) == list(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(), err_msg=k)
    _equal_trees(weights.pipeline_state_dict_to_flax(sd), tree)
    vit_sd = weights.vit_state_dict(tree)  # the stacked tree serves as ViTPoseNet
    for k, v in weights.flax_to_state_dict(want).items():
        np.testing.assert_array_equal(vit_sd[k].numpy(), v.numpy(), err_msg=k)


def _equal_trees(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in b:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


# ---------------------------------------------------------------------------
# the pipelined Trainer at (data 2, pipe 2)
# ---------------------------------------------------------------------------
def _cfg(out: str, **kw) -> Config:
    base = dict(model_type=C.MODEL_18_POINTS_PER_WING_VIT, epochs=2, batch_size=8,
                batches_per_epoch=2, patch_size=16, projection_dim=32, transformer_layers=4,
                num_heads=2, fully_connected_expand=2, dim_head=0, pipeline_stages=2,
                compute_dtype="float32", base_output_path=out, do_augmentations=True,
                rotation_range=10.0, xy_shifts=2.0, val_fraction=0.5, seed=0,
                learning_rate=3e-3)
    base.update(kw)
    return Config(**base)


def _arrays():
    return make_synthetic_arrays(num_frames=8, num_points=8, image_size=48, seed=0)


def _trainer_body(rank, world, out: str):
    from pose_estimation_amitai_torch.train.trainer import Trainer

    viz.available = lambda: False  # this process draws no PNG
    res = {"refused": []}
    for kw in (dict(model_type=C.MODEL_18_POINTS_PER_WING), dict(batch_size=6)):
        try:
            Trainer(_cfg(out, **kw), arrays=_arrays(), device="cpu")
        except ValueError as e:
            res["refused"].append(str(e))
    tr = Trainer(_cfg(out), arrays=_arrays(), device="cpu")
    res["mesh"] = tr.mesh.mesh_dim_names
    res["staged"] = tuple(tr.state.params["blocks.attn.to_qkv.weight"].shape)
    res["history"] = tr.train()
    tr2 = Trainer(_cfg(out, epochs=3, resume_from=tr.run_path), arrays=_arrays(), device="cpu")
    res["start"] = tr2.start_epoch
    res["resumed"] = tr2.train()
    res["run_path"], res["out_channels"] = tr.run_path, tr.model.pipe.out_channels
    return res


@pytest.fixture(scope="module")
def trainer_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipe_trainer")
    return World(_trainer_body, 4, out, str(out)).results()


def test_pipelined_trainer_trains_resumes_and_serves(trainer_world):
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.models.vit import ViTPoseNet
    from pose_estimation_amitai_torch.train.checkpoint import load_variables

    for res in trainer_world:
        assert "ViT" in res["refused"][0] and "batch_size=6" in res["refused"][1]
        assert res["mesh"] == ("data", "pipe")
        assert res["staged"][0] == 2  # this stage's 2 of the 4 blocks
        losses = res["history"]["train_loss"] + res["resumed"]["train_loss"]
        assert np.isfinite(losses).all() and np.isfinite(res["history"]["val_loss"]).all()
        assert losses[-1] < losses[0], losses
        assert res["start"] == 2 and len(res["resumed"]["train_loss"]) == 1
        # every rank ran the same steps on the same draws
        for key in ("train_loss", "val_loss", "l2"):
            assert res["history"][key] == trainer_world[0]["history"][key], key
    run_path, k = trainer_world[0]["run_path"], trainer_world[0]["out_channels"]

    frames = np.random.default_rng(2).random((5, 48, 48, 4)).astype(np.float32)
    pred = Predictor.from_checkpoint(_cfg(str(run_path)), run_path, (48, 48, 4), k,
                                     device="cpu", chunk_size=4, return_heatmaps=True)
    maps, pts = pred(frames)
    params, _ = load_variables(run_path)
    vit = ViTPoseNet(4, 48, k, patch_size=16, dim=32, depth=4, heads=2, dim_head=64,
                     mlp_expand=2, dtype=torch.float32).eval()
    vit.load_state_dict(weights.pipeline_state_dict_to_vit(params))
    with torch.no_grad():
        want = vit(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(maps, want, rtol=0, atol=1e-5)
    assert pts.shape == (5, 3, k)
