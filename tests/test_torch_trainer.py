"""The port's ``Trainer`` on synthetic data (CPU, filters 8, 48 px): the
run-directory artifacts with ``.pt`` checkpoints, true resume, the
checkpoint/viz/best-model gating, host-resident data, C2F's frozen coarse
stage, the multi-camera model end to end, the options that raise, and one
run held against JAX's ``Trainer`` on the same arrays.

Mirrors tests/test_trainer_smoke.py (its mesh cases wait for ROADMAP Queue A
item 14), tests/test_c2f.py and
tests/test_models.py::test_all_cams_all_points_trains_end_to_end. The PNGs
cost seconds a run, so the cases that do not test them run as on a machine
without matplotlib (``viz.available`` patched to False)."""

import csv
import json
import os
import unittest.mock as mock

import numpy as np
import pytest
import torch

from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch import viz, weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.data import make_synthetic_arrays
from pose_estimation_amitai_torch.data.pipeline import HostDataset
from pose_estimation_amitai_torch.train import checkpoint as ckpt
from pose_estimation_amitai_torch.train import trainer as trainer_mod
from pose_estimation_amitai_torch.train.trainer import LOSSES_HEADER, Trainer, _graft_tree

from test_torch_resnet import one_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module")
def arrays():
    return make_synthetic_arrays(num_frames=6, num_points=8, image_size=48, seed=0)


@pytest.fixture
def no_pngs(monkeypatch):
    monkeypatch.setattr(viz, "available", lambda: False)


def _cfg(tmp_path, **kw):
    base = dict(
        epochs=2, batch_size=4, batches_per_epoch=2, accumulation_steps=1,
        num_base_filters=8, base_output_path=str(tmp_path),
        do_augmentations=True, rotation_range=10.0, xy_shifts=2.0,
        val_fraction=0.5, seed=0,
    )
    base.update(kw)
    return Config(**base)


def _spy_checkpoints(calls):
    real = ckpt.save_checkpoint

    def spy(run_path, state, epoch, val_loss, scheduler_state=None, best=False, **kw):
        calls.append((epoch, best))
        return real(run_path, state, epoch, val_loss, scheduler_state=scheduler_state,
                    best=best, **kw)

    return mock.patch.object(trainer_mod.ckpt, "save_checkpoint", spy)


def test_train_artifacts_and_resume(tmp_path, arrays, monkeypatch):
    trainer = Trainer(_cfg(tmp_path), arrays=arrays, device="cpu")
    history = trainer.train()
    assert len(history["train_loss"]) == 2
    assert all(np.isfinite(v) for v in history["train_loss"])

    rp = trainer.run_path
    assert os.path.basename(rp).startswith(f"{C.MODEL_18_POINTS_PER_WING}_")
    for artifact in (
        "configuration.json", "losses.csv", "history.csv", "history.mat", "loss_graph.png",
        "history.png", "checkpoint.pt", "checkpoint_meta.json", "best_model.pt",
        "initial_model.pt", "final_confmaps_model.pt",
    ):
        assert os.path.exists(os.path.join(rp, artifact)), artifact
    code = os.path.join(rp, "training code", "pose_estimation_amitai_torch")
    assert os.path.isfile(os.path.join(code, "train", "trainer.py"))
    assert os.listdir(os.path.join(rp, "l2_histograms"))
    assert os.listdir(os.path.join(rp, "l2_histograms_per_point"))
    assert os.listdir(os.path.join(rp, "viz_pred")) and os.listdir(os.path.join(rp, "viz_confmaps"))
    with open(os.path.join(rp, "losses.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Epoch", "Train Loss", "Val Loss", "L2 Loss", "L2 Std",
                       "L2 Max Outlier", "Epoch Seconds"] == LOSSES_HEADER
    assert [r[0] for r in rows[1:]] == ["1", "2"]
    with open(os.path.join(rp, "configuration.json")) as f:
        assert json.load(f)["num_base_filters"] == 8
    # a second run of the same name gets the _01 suffix
    again = Trainer(_cfg(tmp_path, epochs=0), arrays=arrays, device="cpu")
    assert again.run_path == rp + "_01"

    # -- true resume: 2 more epochs from the checkpoint ------------------
    monkeypatch.setattr(viz, "available", lambda: False)  # PNGs tested above
    trainer2 = Trainer(_cfg(tmp_path, epochs=4, resume_from=rp), arrays=arrays, device="cpu")
    assert trainer2.start_epoch == 2
    assert trainer2.state.step == trainer.state.step > 0  # Adam state restored
    assert trainer2.best_loss == min(history["val_loss"])
    assert trainer2.scheduler.state_dict() == trainer.scheduler.state_dict()
    for k, v in trainer.state.params.items():
        assert torch.equal(trainer2.state.params[k], v), k
    history2 = trainer2.train()
    assert len(history2["train_loss"]) == 2  # epochs 3 and 4 only
    assert not os.path.exists(os.path.join(trainer2.run_path, "initial_model.pt"))


def test_save_every_epoch_weights(tmp_path, arrays, no_pngs):
    """Per-epoch weight snapshots (CallBacks.py:122-128 weights.{epoch}-{loss})."""
    trainer = Trainer(_cfg(tmp_path, save_every_epoch=True), arrays=arrays, device="cpu")
    history = trainer.train()
    names = sorted(os.listdir(os.path.join(trainer.run_path, "weights")))
    assert names == [f"weights.{e + 1:03d}-{v:.9f}.pt"
                     for e, v in enumerate(history["val_loss"])]
    snap = ckpt.load_params(os.path.join(trainer.run_path, "weights", names[-1]))
    assert all(torch.equal(snap[k], v) for k, v in trainer.state.params.items())


def test_accumulation_steps_run(tmp_path, arrays, no_pngs):
    trainer = Trainer(_cfg(tmp_path, epochs=1, accumulation_steps=2, batches_per_epoch=2),
                      arrays=arrays, device="cpu")
    history = trainer.train()
    assert np.isfinite(history["train_loss"][0])
    assert trainer.state.step == 1  # batches_per_epoch // accumulation_steps updates


def test_trainer_with_host_resident_dataset(tmp_path, no_pngs):
    """End to end on the HostDataset feed (host_resident_data=1), from a
    reference-dialect JSON config."""
    arrays = make_synthetic_arrays(num_frames=6, num_points=6, image_size=48, seed=2)
    cfg = {
        "model type": "MODEL_18_POINTS_PER_WING",
        "batch_size": 4, "epochs": 2, "batches per epoch": 2,
        "val_fraction": 0.5, "learning rate": 0.001,
        "number of base filters": 8, "dropout ratio": 0.0,
        "base output path": str(tmp_path), "host_resident_data": 1,
    }
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(cfg))
    tr = Trainer(str(p), arrays=arrays, device="cpu")
    assert type(tr.dataset) is HostDataset
    hist = tr.train()
    assert np.isfinite(hist["val_loss"]).all()
    assert os.path.exists(os.path.join(tr.run_path, "losses.csv"))
    with open(os.path.join(tr.run_path, "configuration.json")) as f:
        assert json.load(f) == cfg  # the raw dialect, as JAX writes it


def test_checkpoint_every_and_viz_gating(tmp_path, arrays):
    """checkpoint_every throttles the resume checkpoint; viz_every <= 0
    writes the PNGs on the final epoch only (CSV/MAT every epoch)."""
    trainer = Trainer(_cfg(tmp_path, epochs=3, batches_per_epoch=1, checkpoint_every=2,
                           viz_every=0, async_checkpoint=False),
                      arrays=arrays, device="cpu")
    calls = []
    with _spy_checkpoints(calls):
        trainer.train()
    assert [e for e, best in calls if not best] == [1], calls
    rp = trainer.run_path
    assert os.listdir(os.path.join(rp, "l2_histograms")) == ["validation_epoch_3.png"]
    with open(os.path.join(rp, "losses.csv")) as f:
        assert len(f.readlines()) == 4  # header + 3 epochs


def test_best_min_rel_delta_gates_best_writes(tmp_path, arrays, no_pngs):
    """best_min_rel_delta=0.99 writes best_model once (the first finite
    improvement); the in-memory best marker still tracks every epoch."""
    trainer = Trainer(_cfg(tmp_path, epochs=3, batches_per_epoch=1, best_min_rel_delta=0.99),
                      arrays=arrays, device="cpu")
    calls = []
    with _spy_checkpoints(calls):
        history = trainer.train()
    assert [e for e, best in calls if best] == [0], calls
    assert trainer.best_loss == min(history["val_loss"])


def test_pngs_skipped_without_matplotlib(tmp_path, arrays, no_pngs, capsys):
    """Without matplotlib (the card's machine) one line says the PNGs are
    skipped and every other artifact is written; profile writes a
    torch.profiler trace and epochs_pointwise_loss switches the loss."""
    trainer = Trainer(_cfg(tmp_path, epochs=2, batches_per_epoch=1, profile=True,
                           epochs_pointwise_loss=1), arrays=arrays, device="cpu")
    history = trainer.train()
    out = capsys.readouterr().out
    assert out.count("the PNG artifacts are skipped") == 1
    assert "Switched training loss to pointwise" in out
    assert trainer.pngs_skipped and np.isfinite(history["train_loss"]).all()
    rp = trainer.run_path
    assert not [f for _, _, fs in os.walk(rp) for f in fs if f.endswith(".png")]
    for artifact in ("losses.csv", "history.csv", "history.mat", "checkpoint.pt",
                     "best_model.pt", "initial_model.pt", "final_confmaps_model.pt"):
        assert os.path.exists(os.path.join(rp, artifact)), artifact
    assert os.listdir(os.path.join(rp, "profile"))


def test_graft_tree_validation():
    """Coarse grafts name missing/extra keys and every shape mismatch
    before anything is cast (tests/test_trainer_smoke.py::test_graft_tree_validation)."""
    tgt = {"a": torch.zeros((2, 3)), "b.w": torch.zeros(4)}
    out = _graft_tree(tgt, {"a": torch.ones((2, 3), dtype=torch.float64),
                            "b.w": torch.ones(4)}, "coarse model")
    assert out["a"].dtype == torch.float32 and torch.equal(out["b.w"], torch.ones(4))
    with pytest.raises(ValueError, match=r"missing b\.w.*unexpected c\.w"):
        _graft_tree(tgt, {"a": torch.ones((2, 3)), "c.w": torch.ones(4)}, "coarse model")
    with pytest.raises(ValueError, match=r"a: \(2, 3\) vs \(3, 2\)"):
        _graft_tree(tgt, {"a": torch.ones((3, 2)), "b.w": torch.ones(4)}, "coarse model")


def test_c2f_loads_frozen_coarse(tmp_path, arrays, no_pngs):
    """Train a coarse model, load it into C2F from its run directory (and,
    as the JAX package writes one, from a msgpack file), and the coarse
    stage stays bit-equal through training (tests/test_c2f.py)."""
    from pose_estimation_amitai_tpu.train import checkpoint as jckpt

    base = dict(epochs=1, batch_size=4, batches_per_epoch=1, num_base_filters=8,
                base_output_path=str(tmp_path), do_augmentations=False,
                val_fraction=0.5, seed=0, arch_flavor="tf")
    coarse = Trainer(Config(model_type=C.COARSE_PER_WING, **base), arrays=arrays, device="cpu")
    coarse.train()
    c2f = Trainer(Config(model_type=C.C2F_PER_WING, coarse_model_path=coarse.run_path, **base),
                  arrays=arrays, device="cpu")
    before = {k: v.clone() for k, v in c2f.state.params.items() if k.startswith("coarse.")}
    assert before and all(torch.equal(v, coarse.state.params[k[len("coarse."):]])
                          for k, v in before.items())
    history = c2f.train()
    assert np.isfinite(history["train_loss"][0])
    assert all(torch.equal(c2f.state.params[k], v) for k, v in before.items())

    jpath = str(tmp_path / "coarse.msgpack")
    jckpt.save_params(jpath, weights.state_dict_to_flax(coarse.state.params))
    from_jax = Trainer(Config(model_type=C.C2F_PER_WING, coarse_model_path=jpath, **base),
                       arrays=arrays, device="cpu")
    assert all(torch.equal(from_jax.state.params[k], v) for k, v in before.items())
    wrong = Trainer(Config(model_type=C.COARSE_PER_WING, **{**base, "num_base_filters": 4}),
                    arrays=arrays, device="cpu")
    wrong_path = ckpt.save_params(str(tmp_path / "narrow.pt"), wrong.state.params)
    with pytest.raises(ValueError, match="coarse model shapes"):
        Trainer(Config(model_type=C.C2F_PER_WING, coarse_model_path=wrong_path, **base),
                arrays=arrays, device="cpu")


def test_all_cams_all_points_trains_end_to_end(tmp_path, no_pngs):
    """ALL_CAMS_ALL_POINTS through the Trainer: the 4-camera channel concat
    -> MultiCamNet -> one epoch (tests/test_models.py)."""
    arrays = make_synthetic_arrays(num_frames=6, num_points=8, image_size=48, seed=0)
    cfg = Config(model_type=C.ALL_CAMS_ALL_POINTS, epochs=1, batch_size=4,
                 batches_per_epoch=1, num_base_filters=8, dropout_ratio=0.0,
                 base_output_path=str(tmp_path), do_augmentations=True,
                 rotation_range=10.0, xy_shifts=2.0, val_fraction=0.5, seed=0)
    history = Trainer(cfg, arrays=arrays, device="cpu").train()
    assert np.isfinite(history["train_loss"][0])
    assert np.isfinite(history["val_loss"][0])


@pytest.mark.parametrize("kw, item", [
    ({"mesh_shape": (1,)}, "item 14"),
    ({"pipeline_stages": 2}, "item 14"),
    ({"pretrained_encoder_path": "encoder.pt"}, "items 12 and 13"),
    ({"model_type": C.C2F_PER_WING, "coarse_model_path": "h5"}, "item 13"),
])
def test_unported_options_raise(tmp_path, arrays, kw, item):
    """Item 14 raises NotImplementedError; items 12 and 13 are ported
    (tests/test_torch_selfsup.py, test_torch_importers.py), so their
    options now reach their readers, which refuse a missing encoder file and
    a keras save with no weights."""
    if kw.get("coarse_model_path") == "h5":  # a reference keras save: HDF5
        import h5py

        path = str(tmp_path / "coarse per wing sigma 6 model.h5")
        with h5py.File(path, "w") as f:
            f.create_group("model_weights")
        kw = {**kw, "coarse_model_path": path}
    error, match = {
        "item 14": (NotImplementedError, item),
        "items 12 and 13": (FileNotFoundError, "encoder.pt"),
        "item 13": (ValueError, "no conv kernels"),
    }[item]
    with pytest.raises(error, match=match):
        Trainer(_cfg(tmp_path, **kw), arrays=arrays, device="cpu")


# ---------------------------------------------------------------------------
# one run against JAX's Trainer
# ---------------------------------------------------------------------------
PARITY = dict(epochs=2, batch_size=4, batches_per_epoch=2, num_base_filters=8,
              compute_dtype="float32", do_augmentations=False, dropout_ratio=0.0,
              val_fraction=0.5, seed=0, async_checkpoint=False)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, arrays):
    """JAX's Trainer (batch 4: not a multiple of the 8 virtual devices, so
    its single-device path) and its initial parameters."""
    from pose_estimation_amitai_tpu.config import Config as JConfig
    from pose_estimation_amitai_tpu.train.trainer import Trainer as JTrainer

    out = tmp_path_factory.mktemp("jax_run")
    jt = JTrainer(JConfig(base_output_path=str(out), **PARITY), arrays=arrays)
    assert jt.mesh is None
    history = jt.train()
    return history, os.path.join(jt.run_path, "initial_model.msgpack")


def test_trainer_matches_jax_trainer(tmp_path, arrays, jax_run, no_pngs):
    """Same arrays, same split and batch ring, JAX's initial parameters
    through the bridge: per-epoch losses within 1e-4 relative, mean pixel
    L2 within 1e-3 px."""
    jhistory, initial = jax_run
    trainer = Trainer(Config(base_output_path=str(tmp_path), **PARITY), arrays=arrays,
                      device="cpu")
    tree, _ = weights.load_checkpoint(initial)
    trainer.state = trainer.state.replace(params=weights.flax_to_state_dict(tree, trainer.model))
    history = trainer.train()
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(history[key], jhistory[key], rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(history["l2"], jhistory["l2"], atol=1e-3)


# ---------------------------------------------------------------------------
# the BatchNorm families and the camera-matrix model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model_type", [C.ALL_CAMS_DISENTANGLED_PER_WING_CNN])
def test_batchnorm_family_run_directory_and_resume(tmp_path, arrays, no_pngs, model_type,
                                                   one_thread):
    """The running averages in every file of the run directory (the full
    checkpoints' ``batch_stats``, the weights-only snapshots beside the
    parameters), a resume that restores them, and the run directory served
    through ``Predictor.from_checkpoint`` on them with the samples' cameras
    (float32: the CPU's bf16 convolutions are slow)."""
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.train.loop import make_predict_fn, model_args

    cfg = _cfg(tmp_path, model_type=model_type, save_every_epoch=True, batch_size=2,
               compute_dtype="float32")
    trainer = Trainer(cfg, arrays=arrays, device="cpu")
    stats0 = trainer.state.batch_stats
    history = trainer.train()
    assert all(np.isfinite(history["train_loss"] + history["val_loss"]))
    state = trainer.state
    assert state.batch_stats and set(state.batch_stats) == set(stats0)
    assert any(not torch.equal(state.batch_stats[n], v) for n, v in stats0.items())
    rp = trainer.run_path
    snap = sorted(os.listdir(os.path.join(rp, "weights")))[-1]
    for name in ("final_confmaps_model.pt", os.path.join("weights", snap), "checkpoint.pt"):
        params, stats = ckpt.load_variables(os.path.join(rp, name))
        assert set(params) == set(state.params) and set(stats) == set(state.batch_stats), name
        assert all(torch.equal(stats[n], v) for n, v in state.batch_stats.items()), name
    assert set(ckpt.load_params(os.path.join(rp, "final_confmaps_model.pt"))) == set(state.params)

    trainer2 = Trainer(cfg.replace(epochs=3, resume_from=rp), arrays=arrays, device="cpu")
    assert trainer2.start_epoch == 2
    assert all(torch.equal(trainer2.state.batch_stats[n], v)
               for n, v in state.batch_stats.items())
    trainer2.train()
    assert trainer2.state.step == 3 * cfg.batches_per_epoch

    ds = trainer2.dataset
    batch = ds.gather(np.arange(ds.num_samples))
    box, k = batch["image"].numpy(), batch["confmaps"].shape[-1]
    cams = {"cameras": (batch["P"].numpy(), batch["P_inv"].numpy())} if "P" in batch else {}
    pred = Predictor.from_checkpoint(cfg, trainer2.run_path, box.shape[1:], k, device="cpu",
                                     chunk_size=3, return_heatmaps=True, **cams)
    maps, _ = pred(box)
    served, served_stats = ckpt.load_variables(trainer2.run_path)  # the file it served
    want = make_predict_fn(trainer2.model)(served, *model_args(batch), batch_stats=served_stats)
    np.testing.assert_allclose(maps, want.numpy(), atol=2e-2 * np.abs(want.numpy()).max())
