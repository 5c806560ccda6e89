"""Self-supervised inpainting pretraining of the port against the JAX
package's (train/selfsup.py; reference: pytorch/self supervision/
train_self_supervision.py)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pose_estimation_amitai_torch import cli, weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.data.synthetic import make_synthetic_arrays
from pose_estimation_amitai_torch.models.cnn import BasicNet
from pose_estimation_amitai_torch.train import selfsup
from pose_estimation_amitai_torch.train.loop import TrainState, create_optimizer
from pose_estimation_amitai_torch.train.trainer import Trainer
from pose_estimation_amitai_tpu.config import Config as JConfig
from pose_estimation_amitai_tpu.models.cnn import BasicNet as JBasicNet
from pose_estimation_amitai_tpu.train import loop as jloop
from pose_estimation_amitai_tpu.train import selfsup as jselfsup

from test_torch_resnet import one_thread  # noqa: F401 (a fixture)

HW = 48
GRAD_RTOL = 1e-4  # tests/test_torch_train.py's tolerances
PARAM_ATOL = 1e-6
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread_here(one_thread):
    """Every case on one intra-op thread (workers of the parallel run share
    the cores)."""


def _crops(n=12, hw=HW, seed=0):
    """(N, hw, hw, 5) synthetic crops: 3 blobby time channels + 2 masks
    (tests/test_selfsup.py's)."""
    rng = np.random.default_rng(seed)
    crops = np.zeros((n, hw, hw, 5), np.float32)
    ys, xs = np.mgrid[0:hw, 0:hw]
    for i in range(n):
        cy, cx = rng.integers(16, hw - 16, 2)
        blob = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * 8.0 ** 2))
        crops[i, ..., :3] = blob[..., None]
        crops[i, ..., 3] = (np.abs(ys - cy) < 10) & (xs < cx)
        crops[i, ..., 4] = (np.abs(ys - cy) < 10) & (xs >= cx)
    return crops


def test_create_holes_forced_centres_equal_jax():
    """Exactly 3 mask pixels and exactly 5 body pixels: every draw takes all
    of them, so the holed images are bit-equal to JAX's whatever the draws.
    Body pixels at the corners hold the clipping of a hole at the border."""
    rng = np.random.default_rng(1)
    imgs = np.zeros((2, HW, HW, 4), np.float32)
    imgs[..., :3] = rng.random((2, HW, HW, 3)) * 0.5 - 1.0  # time channels, sum < 0
    body = [[(0, 0), (HW - 1, HW - 1), (20, 5), (30, 30), (5, 40)],
            [(0, HW - 1), (HW - 1, 0), (24, 24), (8, 8), (40, 12)]]
    mask = [[(3, 3), (10, 20), (HW - 1, 30)], [(0, 0), (33, 2), (17, 40)]]
    for i in range(2):
        for y, x in body[i]:
            imgs[i, y, x, :3] = 1.0
        for y, x in mask[i]:
            imgs[i, y, x, 3] = 1.0
    want = np.asarray(jselfsup.create_holes(jax.random.key(3), jnp.asarray(imgs)))
    got = selfsup.create_holes(torch.Generator().manual_seed(5), torch.from_numpy(imgs))
    np.testing.assert_array_equal(got.numpy(), want)
    # the hole at (0, 0) spans [0, 16) once its corner is clipped, not [-8, 8)
    assert (want[0, :16, :16] == 0).all() and (want[0, 16, 17, :3] != 0).all()


def test_create_holes_assembles_jax_boxes():
    """The holes of a draw are JAX's boxes (``_box_hole_mask``, top-left
    clipped at 0) at the draw's centres, the wing holes sized
    sqrt(nnz(mask)) // 2: replayed from a generator in the same state."""
    crops = _crops(4)
    imgs = torch.from_numpy(np.concatenate([crops[..., :3], crops[..., 3:4]], -1))
    got = selfsup.create_holes(torch.Generator().manual_seed(9), imgs)
    g = torch.Generator().manual_seed(9)
    wy, wx = selfsup._sample_coords_topk(g, imgs[..., -1], selfsup.NUM_WING_HOLES)
    by, bx = selfsup._sample_coords_topk(g, (imgs[..., :3].sum(-1) > 0).float(),
                                         selfsup.NUM_BODY_HOLES)
    for i in range(4):
        size = int(np.sqrt(np.float32(np.count_nonzero(crops[i, ..., 3] > 0)))) // 2
        assert size > 0
        hole = np.zeros((HW, HW), bool)
        for y, x in zip(wy[i].tolist(), wx[i].tolist()):
            hole |= np.asarray(jselfsup._box_hole_mask(HW, HW, y, x, size))
        for y, x in zip(by[i].tolist(), bx[i].tolist()):
            hole |= np.asarray(jselfsup._box_hole_mask(HW, HW, y, x, selfsup.BODY_HOLE_SIZE))
        want = imgs[i].numpy() * (~hole)[..., None]
        np.testing.assert_array_equal(got[i].numpy(), want)


def test_hole_centres_uniform_over_the_mask():
    """Centres fall only on mask pixels, distinct within a draw, and about
    uniformly over them."""
    w = torch.zeros(1, 16, 16)
    w[0, 2:6, 3:8] = 1.0  # 20 pixels
    g = torch.Generator().manual_seed(0)
    counts = np.zeros((16, 16))
    draws = 2000
    for _ in range(draws):
        ys, xs = selfsup._sample_coords_topk(g, w, 3)
        pts = set(zip(ys[0].tolist(), xs[0].tolist()))
        assert len(pts) == 3
        for y, x in pts:
            counts[y, x] += 1
    assert counts[w[0].numpy() == 0].sum() == 0
    inside = counts[w[0].numpy() > 0]
    mean = 3 * draws / 20  # 300 a pixel
    assert np.abs(inside - mean).max() < 0.25 * mean, inside


def test_select_wing_channel_equals_jax():
    crops = jnp.asarray(_crops(8))
    key = jax.random.key(0)
    which = np.asarray(jax.random.bernoulli(key, 0.5, (8,)))
    assert 0 < which.sum() < 8
    want = np.asarray(jselfsup.select_wing_channel(key, crops))
    got = selfsup.select_wing_channel(torch.from_numpy(np.asarray(crops)),
                                      torch.from_numpy(which))
    np.testing.assert_array_equal(got.numpy(), want)


def test_selfsup_step_matches_jax():
    """One float32 step at dropout 0 on a given (holed, clean) batch: loss,
    gradients and the Adam update against jax.value_and_grad of JAX's loss
    and optax's update."""
    kw = dict(num_base_filters=8, compute_dtype="float32", dropout_ratio=0.0)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    crops = _crops(4)
    clean = np.concatenate([crops[..., :3], crops[..., 4:5]], -1)
    holed = np.asarray(jselfsup.create_holes(jax.random.key(2), jnp.asarray(clean)))
    # a hole is a constant patch, so the max-pools see exact ties there, and
    # XLA and PyTorch route a tied window's gradient to different (equally
    # valid) elements: a little noise breaks the ties
    holed = holed + np.random.default_rng(4).random(holed.shape, np.float32) * 1e-3
    jmodel = JBasicNet(out_channels=4, filters=8, dropout=0.0, dtype=jnp.float32)
    jparams = jmodel.init({"params": jax.random.key(0)}, jnp.asarray(clean[:1]),
                          train=False)["params"]

    def jloss_fn(p):
        recon = jmodel.apply({"params": p}, jnp.asarray(holed), train=True,
                             rngs={"dropout": jax.random.key(1)})
        return jnp.mean(jnp.square(recon.astype(jnp.float32) - jnp.asarray(clean)))

    jl, jg = jax.jit(jax.value_and_grad(jloss_fn))(jparams)
    tx = jloop.create_optimizer(jcfg)
    updates, _ = tx.update(jg, tx.init(jparams), jparams)
    jnew = optax.apply_updates(jparams, updates)

    with torch.device("meta"):
        model = BasicNet(4, out_channels=4, filters=8, dropout=0.0, dtype=torch.float32)
    params = weights.flax_to_state_dict(jparams)
    state = TrainState(step=0, params=params, seed=0,
                       opt_state=create_optimizer(cfg, list(params.values())).state_dict())
    th, tc = torch.from_numpy(holed), torch.from_numpy(clean)
    loss, grads = selfsup.make_loss_and_grads(model)(params, th, tc, torch.Generator())
    new, loss2 = selfsup.make_selfsup_step(model, cfg)(state, th, tc, torch.Generator())
    assert new.step == 1 and float(loss2) == float(loss)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    want_g = weights.flax_to_state_dict(jg)
    want_p = weights.flax_to_state_dict(jnew)
    for k in params:
        g, wg = grads[k].numpy(), want_g[k].numpy()
        top = np.abs(wg).max()
        np.testing.assert_allclose(g, wg, atol=GRAD_RTOL * top, rtol=0, err_msg=k)
        same = np.sign(g) == np.sign(wg)
        assert np.abs(wg[~same]).max(initial=0.0) <= GRAD_RTOL * top, k
        # Adam's first update is lr * g / (|g| + eps): where |g| is near eps
        # the gradients' own difference moves it by lr * eps * |g - g'| /
        # ((|g| + eps) (|g'| + eps)) (chip_smoke.py's train phase holds it so)
        eps, lr = 1e-8, cfg.learning_rate
        explained = lr * eps * np.abs(g - wg) / ((np.abs(g) + eps) * (np.abs(wg) + eps))
        d = np.abs(new.params[k].numpy() - want_p[k].numpy()) - explained
        assert d[same].max(initial=0.0) <= PARAM_ATOL, (k, d[same].max())


def test_pretrain_then_finetune_loads_encoder(tmp_path):
    """The port's pretraining writes a run directory whose encoder re-heads
    a supervised model through pretrained_encoder_path; a JAX SelfSupTrainer
    run directory (msgpack) does the same. Validation draws are the same
    every epoch: two evaluations of one state agree."""
    cfg = Config(epochs=2, batch_size=4, batches_per_epoch=2, num_base_filters=8,
                 base_output_path=str(tmp_path), do_augmentations=True,
                 rotation_range=10.0, xy_shifts=2.0, seed=0)
    pre = selfsup.SelfSupTrainer(cfg, _crops(10), device="cpu")
    history = pre.train()
    assert len(history["train_loss"]) == 2
    assert all(np.isfinite(history["train_loss"] + history["val_loss"]))
    assert {"checkpoint.pt", "best_model.pt", "checkpoint_meta.json",
            "configuration.json"} <= set(os.listdir(pre.run_path))
    ids = pre.val_inds[:1]
    assert float(pre.eval_step(ids)[0]) == float(pre.eval_step(ids)[0])

    jcfg = JConfig(epochs=1, batch_size=4, batches_per_epoch=1, num_base_filters=8,
                   base_output_path=str(tmp_path / "jax"), do_augmentations=False, seed=0)
    jpre = jselfsup.SelfSupTrainer(jcfg, _crops(8))
    jpre.train()

    arrays = make_synthetic_arrays(num_frames=4, num_points=8, image_size=48)
    best = torch.load(os.path.join(pre.run_path, "best_model.pt"))["params"]
    for run, want in ((pre.run_path, best),
                      (jpre.run_path, weights.flax_to_state_dict(jpre.state.params))):
        ft = Trainer(cfg.replace(pretrained_encoder_path=run, epochs=1, batches_per_epoch=1,
                                 val_fraction=0.5, do_augmentations=False),
                     arrays=arrays, device="cpu")
        for k, v in ft.state.params.items():
            if k.startswith("encoder."):
                np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    assert np.isfinite(ft.train()["train_loss"][0])


def test_main_h5_path_normalizes_uint8(tmp_path, monkeypatch):
    """The H5 source lands in the supervised input scale ([0, 1]), cameras
    flattened."""
    import h5py

    h5 = str(tmp_path / "crops.h5")
    with h5py.File(h5, "w") as f:
        f["box"] = np.random.default_rng(0).integers(0, 256, (3, 2, 16, 16, 5)).astype(np.uint8)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump({"epochs": 1, "batch_size": 2, "base output path": str(tmp_path)}, f)
    seen = {}

    class FakeTrainer:
        def __init__(self, cfg, crops, *, device):
            seen["crops"], seen["device"] = crops, device

        def train(self):
            return {}

    monkeypatch.setattr(selfsup, "SelfSupTrainer", FakeTrainer)
    selfsup.main([cfg_path, h5], device="cpu")
    crops = seen["crops"]
    assert crops.shape == (6, 16, 16, 5) and seen["device"] == "cpu"
    assert crops.dtype == np.float32 and crops.max() <= 1.0


def test_cli_pretrain(tmp_path):
    """``cli pretrain <config> <crops dir> --device cpu`` writes a run
    directory from .npy crops."""
    crops_dir = tmp_path / "crops"
    crops_dir.mkdir()
    for i, c in enumerate(_crops(6)):
        np.save(crops_dir / f"crop_{i:03d}.npy", c)
    out = tmp_path / "runs"
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump({"epochs": 1, "batch size": 2, "batches per epoch": 1,
                   "number of base filters": 8, "base output path": str(out)}, f)
    assert cli.main(["pretrain", cfg_path, str(crops_dir), "--device", "cpu"]) == 0
    (run,) = os.listdir(out)
    assert run.startswith("self_supervision_")
    assert {"checkpoint.pt", "best_model.pt"} <= set(os.listdir(out / run))
