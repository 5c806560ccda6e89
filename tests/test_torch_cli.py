"""The port's CLI on the CPU (``--device cpu``) against the JAX package's:
``train`` on an H5 file written here, ``eval`` of the run directory equal to
JAX's ``cli eval`` on the same checkpoint carried to msgpack through the
weight bridge (the disentangled camera model's too), ``infer``'s .npz keys
and shapes as JAX's, and the subcommands and options that wait for later
Queue A items."""

import json
import os

import numpy as np
import pytest
import torch

from pose_estimation_amitai_torch import cli, weights
from pose_estimation_amitai_torch.data.synthetic import write_synthetic_h5
from pose_estimation_amitai_tpu import cli as jcli
from pose_estimation_amitai_tpu.train import checkpoint as jckpt

from test_torch_resnet import one_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """An H5 file, a config and the run directory ``cli train`` made."""
    root = tmp_path_factory.mktemp("cli")
    data = write_synthetic_h5(str(root / "data.h5"), num_frames=4, num_points=8,
                              image_size=48, seed=0)
    cfg = {"model type": "MODEL_18_POINTS_PER_WING", "batch_size": 4, "epochs": 1,
           "batches per epoch": 1, "number of base filters": 8, "compute_dtype": "float32",
           "base output path": str(root / "runs"), "data_path": data, "val_fraction": 0.5,
           "viz_every": 0}
    cfg_path = str(root / "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    assert cli.main(["train", cfg_path, "--device", "cpu"]) == 0
    (run,) = os.listdir(root / "runs")
    run = str(root / "runs" / run)
    # the same checkpoint in the JAX package's format, through the bridge
    tree, _ = weights.load_checkpoint(run)
    jpath = str(root / "best_model.msgpack")
    jckpt.save_params(jpath, tree)
    return root, cfg_path, data, run, jpath


def _json_out(capsys) -> dict:
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


def test_train_writes_a_run_directory(trained):
    _, _, _, run, _ = trained
    for name in ("best_model.pt", "checkpoint.pt", "losses.csv", "configuration.json",
                 "final_confmaps_model.pt"):
        assert os.path.exists(os.path.join(run, name)), name


def test_eval_equals_jax_cli_eval(trained, capsys):
    _, cfg_path, data, run, jpath = trained
    capsys.readouterr()
    assert cli.main(["eval", cfg_path, run, data, "--device", "cpu"]) == 0
    got = _json_out(capsys)
    assert jcli.main(["eval", cfg_path, jpath, data]) == 0
    want = _json_out(capsys)
    assert got.keys() == want.keys() and got["softmax"] == want["softmax"] == "exact"
    for key in ("l2_mean", "l2_std", "l2_max", "l2_per_point"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)


def test_infer_npz_matches_jax(trained, capsys):
    root, cfg_path, data, run, jpath = trained
    ours, theirs = str(root / "ours.npz"), str(root / "theirs.npz")
    assert cli.main(["infer", cfg_path, run, data, ours, "--mat", "--device", "cpu"]) == 0
    assert os.path.exists(str(root / "ours.mat"))
    assert jcli.main(["infer", cfg_path, jpath, data, theirs]) == 0
    got, want = np.load(ours), np.load(theirs)
    assert set(got.files) == set(want.files) >= {"points_2d", "points_3d", "points_3d_valid"}
    for key in want.files:
        assert got[key].shape == want[key].shape, key
    np.testing.assert_array_equal(got["points_2d"][:, :2], want["points_2d"][:, :2])
    np.testing.assert_array_equal(got["points_3d_valid"], want["points_3d_valid"])


@pytest.mark.parametrize("argv, item", [
    (["pretrain", "c.json"], "item 12"),
    (["export", "c.json", "ckpt", "out.pexp"], "item 13"),
    (["import", "model.h5", "out.msgpack"], "item 13"),
])
def test_unported_subcommands_raise(argv, item, tmp_path, monkeypatch):
    """Items 12 and 13 are ported (tests/test_torch_selfsup.py,
    test_torch_importers.py, test_torch_deploy.py): each subcommand reaches
    its reader, which refuses the missing file, and none names its item."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError) as err:
        cli.main(argv + ["--device", "cpu"] if argv[0] != "import" else argv)
    assert item not in str(err.value)


@pytest.mark.parametrize("flag, item", [
    (["--import-reference"], "item 13"),
    (["--dim-head", "64"], "item 13"),
])
def test_unported_options_raise(trained, flag, item):
    """Item 13 is ported: ``--import-reference`` refuses the port's own run
    directory (no reference checkpoint file), and ``--dim-head``, which
    only an imported torch ViT reads, leaves the eval as it was."""
    _, cfg_path, data, run, _ = trained
    if flag[0] == "--import-reference":
        with pytest.raises(FileNotFoundError, match="no such checkpoint file"):
            cli.main(["eval", cfg_path, run, data, "--device", "cpu", *flag])
    else:
        assert cli.main(["eval", cfg_path, run, data, "--device", "cpu", *flag]) == 0


def test_device_defaults_to_cuda(trained):
    """No automatic CPU: without --device the card is asked for."""
    _, cfg_path, data, run, _ = trained
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["eval", cfg_path, run, data])


@pytest.fixture(scope="module")
def trained_cameras(tmp_path_factory):
    """``cli train`` of the disentangled camera model on an H5 file, and its
    best checkpoint in the JAX package's format with the running averages
    (a training-state payload: JAX's reader takes ``batch_stats`` only from
    one)."""
    from flax import serialization

    root = tmp_path_factory.mktemp("cli_cameras")
    data = write_synthetic_h5(str(root / "data.h5"), num_frames=4, num_points=8,
                              image_size=48, seed=1)
    cfg = {"model type": "ALL_CAMS_DISENTANGLED_PER_WING_CNN", "batch_size": 2, "epochs": 1,
           "batches per epoch": 1, "number of base filters": 8, "compute_dtype": "float32",
           "base output path": str(root / "runs"), "data_path": data, "val_fraction": 0.5,
           "viz_every": 0}
    cfg_path = str(root / "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the one_thread fixture's reason
    try:
        assert cli.main(["train", cfg_path, "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    (run,) = os.listdir(root / "runs")
    run = str(root / "runs" / run)
    tree, stats = weights.load_checkpoint(run)
    assert set(stats) == {"bn1", "bn2", "bn3"}
    jpath = str(root / "best_model.msgpack")
    with open(jpath, "wb") as f:
        f.write(serialization.to_bytes({"params": tree, "opt_state": {}, "batch_stats": stats}))
    return cfg_path, data, run, jpath


def test_quantized_layers_infer_serves_int8_generic(trained_cameras, tmp_path, monkeypatch,
                                                   one_thread):
    """``infer --quantized --quantized-layers conv_only`` on the camera model
    serves on "int8_generic" with its cameras and writes the points of
    every sample."""
    from pose_estimation_amitai_torch import infer

    cfg_path, data, run, _ = trained_cameras
    made = []
    real = infer.Predictor.from_checkpoint.__func__

    def spy(cls, *args, **kw):
        made.append(real(cls, *args, **kw))
        return made[-1]

    monkeypatch.setattr(infer.Predictor, "from_checkpoint", classmethod(spy))
    out = str(tmp_path / "q.npz")
    assert cli.main(["infer", cfg_path, run, data, out, "--device", "cpu", "--quantized",
                     "--quantized-layers", "conv_only"]) == 0
    assert made[0].serving_path == "int8_generic"
    pts = np.load(out)["points_2d"]
    assert pts.shape[1:] == (3, 24) and pts.shape[0] > 0 and np.isfinite(pts).all()


def test_eval_of_a_camera_model_equals_jax_cli_eval(trained_cameras, capsys, one_thread):
    """The camera model's samples and crop-adjusted cameras built as JAX's
    CLI builds them, served on the run directory's running averages."""
    cfg_path, data, run, jpath = trained_cameras
    capsys.readouterr()
    assert cli.main(["eval", cfg_path, run, data, "--device", "cpu", "--chunk-size", "3"]) == 0
    got = _json_out(capsys)
    assert jcli.main(["eval", cfg_path, jpath, data, "--chunk-size", "3"]) == 0
    want = _json_out(capsys)
    assert got.keys() == want.keys() and len(got["l2_per_point"]) == 24
    for key in ("l2_mean", "l2_std", "l2_max", "l2_per_point"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
