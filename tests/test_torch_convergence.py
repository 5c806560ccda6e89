"""Learning happens in the port (tests/test_convergence.py on the CPU):
short full-pipeline training beats the zero-prediction baseline on held-out
data, and a model overfit on one batch localises its peaks to a few pixels.

Same data, configuration, step counts and limits as the JAX tests: 12
synthetic 48-px frames, filters 8, dropout 0, no augmentation, 22 epochs of
10 updates, a best validation loss under 0.9 of the all-zero prediction's;
one batch of 8, 1200 Adam steps at 1e-3 (the JAX test's loop runs 1200,
not the 300 its docstring says), a median peak distance of at most 3 px.

Both limits sit inside the spread of single runs, in JAX as in the port.
Best/zero ratios of the 22-epoch run at seeds 0, 1, 2: JAX's Trainer on one
CPU device 0.999, 0.999, 0.882 (the JAX test passes at seed 0 on the
tests' 8-device CPU mesh, whose sharded sums round otherwise), the port's
0.964, 0.822, 0.794. So the port's run is held
over those three seeds, by the median of their ratios. The overfit run
starts where the JAX test starts, flax's initial parameters at key 0
bridged to the port (weights.flax_to_state_dict): 1.91 px in the port,
1.71 in JAX; from the port's own initialiser at seed 0 it ends at 3.6 px,
at seed 1 at 0.5, and JAX's keys 0, 1, 2 end at 1.7, 2.5, 2.1."""

import numpy as np
import pytest
import torch
from torch.func import functional_call

import jax
import jax.numpy as jnp

from pose_estimation_amitai_torch import viz, weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.data.pipeline import build_dataset
from pose_estimation_amitai_torch.data.synthetic import make_synthetic_arrays
from pose_estimation_amitai_torch.models import build_model
from pose_estimation_amitai_torch.ops import peaks
from pose_estimation_amitai_torch.train.trainer import Trainer
from pose_estimation_amitai_tpu.config import Config as JConfig
from pose_estimation_amitai_tpu.models import build_model as jbuild_model

from test_torch_resnet import one_thread  # noqa: F401 (a fixture)

BASELINE_FRACTION = 0.9  # best val loss < 0.9 x the zero prediction's
SEEDS = (0, 1, 2)  # the baseline run's, held by the median of their ratios
OVERFIT_STEPS = 1200
MEDIAN_PX = 3.0  # random guessing on a 48-px frame lands ~19 px away


@pytest.fixture(autouse=True)
def _one_thread_here(one_thread):
    """Every case of this file on one intra-op thread (test_torch_resnet.py
    ``one_thread``: workers of the parallel run share the cores)."""


def test_flagship_beats_zero_baseline_on_val(tmp_path, monkeypatch):
    monkeypatch.setattr(viz, "available", lambda: False)
    arrays = make_synthetic_arrays(num_frames=12, num_points=8, image_size=48, seed=5)
    ratios = []
    for seed in SEEDS:
        cfg = Config(
            epochs=22, batch_size=8, batches_per_epoch=10,
            num_base_filters=8, learning_rate=1e-3,
            dropout_ratio=0.0,  # p=0.5 needs the reference's 2000-epoch horizon
            base_output_path=str(tmp_path / str(seed)),
            do_augmentations=False,  # isolate optimisation from augmentation
            val_fraction=0.25, seed=seed,
        )
        trainer = Trainer(cfg, arrays=arrays, device="cpu")
        ds = trainer.dataset
        val_cm = ds.gather(np.asarray(ds.val_inds))["confmaps"].double().numpy()
        # the do-nothing baseline: predicting all-zero heatmaps
        zero_baseline = float(np.mean(np.square(val_cm)))
        history = trainer.train()
        assert np.isfinite(history["l2"]).all()
        ratios.append(min(history["val_loss"]) / zero_baseline)
    assert np.median(ratios) < BASELINE_FRACTION, ratios


def test_overfit_one_batch_localises_peaks():
    """1200 Adam steps on one batch of the eval forward's MSE, from flax's
    initial parameters at key 0 -> decoded peaks within a median of 3 px
    of the targets'."""
    arrays = make_synthetic_arrays(num_frames=4, num_points=8, image_size=48, seed=5)
    cfg = Config(num_base_filters=8, dropout_ratio=0.0)
    ds, _ = build_dataset(cfg, arrays, device="cpu")
    batch = ds.gather(np.arange(8))
    x, y = batch["image"], batch["confmaps"].float()
    model = build_model(cfg, tuple(x.shape[1:]), y.shape[-1]).eval()
    jmodel = jbuild_model(JConfig(num_base_filters=8, dropout_ratio=0.0),
                          tuple(x.shape[1:]), y.shape[-1])
    init = jmodel.init({"params": jax.random.key(0)}, jnp.asarray(x.numpy()),
                       train=False)["params"]
    params = {k: v.requires_grad_() for k, v in weights.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, init), model).items()}
    opt = torch.optim.Adam(params.values(), lr=1e-3)
    for _ in range(OVERFIT_STEPS):
        opt.zero_grad()
        loss = torch.square(functional_call(model, params, (x,)) - y).mean()
        loss.backward()
        opt.step()
    with torch.no_grad():
        pred = functional_call(model, params, (x,))
        l2 = peaks.l2_distances(pred, y).numpy()
    # the mean is skewed by the few synthetic keypoints outside their crops
    assert np.median(l2) <= MEDIAN_PX, np.median(l2)
