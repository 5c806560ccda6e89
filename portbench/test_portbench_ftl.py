"""CPU tests of the cell ``ftl.movie`` (the 4-camera disentanglement model
through ``predict_movie`` with each sample's cameras), at the size of
``portbench.tiny`` with the model cut to filters 8: the cell runs and is
``correct``, traced and not; the plain reference equals the port's module
route in float32; the work counts; and ``correct`` comes out false for the
control and for each fault planted in the port underneath a run.

Run with ``python -m pytest portbench -m '' -p no:cacheprovider``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, manifest, work
from portbench.drivers import camera_movie
from portbench.families import basicnet, disentangled
from portbench.tiny import small_config, tiny_manifest

ROOT = Path(__file__).resolve().parent.parent
CELL = "ftl.movie"
CONFIG = "ftl_disentangled_cnn"
SEED = 2**31 + 2468  # more than 32 signed bits hold, as the driver's seeds
FILTERS = 8


def tiny_spec(spec: dict) -> dict:
    """The configuration at the tiny preset's size, the widths of its
    encoder and decoder cut to ``FILTERS``."""
    spec = small_config(spec)
    spec["filters"] = spec["port_config"]["num_base_filters"] = FILTERS
    return spec


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    bench = tiny_manifest(tmp_path_factory.mktemp("tiny"))
    path = bench.root / f"pb/configs/{CONFIG}.json"
    path.write_text(json.dumps(tiny_spec(json.loads(
        (ROOT / f"portbench/configs/{CONFIG}.json").read_text()))))
    return manifest.Manifest(bench.path)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(tiny, trace):
    c = tiny.cell(CELL)
    r = harness.run_cell(tiny, c, SEED, 0.5, trace, "cpu", 0.0)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"peak_gap", "val_err"} and r["failed"] == 0
    wanted = c.per_layer if trace else c.end_to_end
    if trace:
        wanted = [m for m in wanted if "_roofline" not in m["name"]]
    assert {m["name"] for m in wanted} <= set(r["metrics"])


def _variables(spec):
    from portbench.weights import make_tree

    tree, dev = make_tree(disentangled.leaves(spec), SEED, torch.device("cpu"))
    return (*disentangled.split_tree(tree), dev)


def test_reference_matches_the_port():
    """The plain reference against the port's module route in float32 on the
    same seeded variables and cameras: maps within 1e-4 of their range."""
    from portbench import program

    spec = tiny_spec(json.loads((ROOT / f"portbench/configs/{CONFIG}.json").read_text()))
    params, stats, dev = _variables(spec)
    cams = camera_movie.camera_rows(6, SEED, spec["image_shape"][0])
    from pose_estimation_amitai_torch.infer import Predictor

    pred = Predictor(program.port_config(spec, compute_dtype="float32"), params,
                     tuple(spec["image_shape"]), spec["out_channels"], device="cpu",
                     chunk_size=4, return_heatmaps=True, batch_stats=stats, cameras=cams)
    assert pred.serving_path == "module"
    frames = torch.rand((6, *spec["image_shape"]), generator=torch.Generator().manual_seed(3))
    maps, _ = pred(frames.numpy())
    ref = disentangled.forward(dev, frames, spec, P=torch.from_numpy(cams[0]),
                               P_inv=torch.from_numpy(cams[1])).numpy()
    assert np.abs(maps - ref).max() <= 1e-4 * (ref.max() - ref.min())


def test_cameras_are_crop_adjusted():
    """Unit Frobenius norms, P P_inv a multiple of the identity, the rows
    the same for the same seed, and each crop its own camera."""
    P, P_inv = camera_movie.camera_rows(5, SEED, 192)
    assert P.shape == (5, 4, 3, 4) and P_inv.shape == (5, 4, 4, 3)
    np.testing.assert_allclose(np.linalg.norm(P, axis=(-2, -1)), 1, rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(P_inv, axis=(-2, -1)), 1, rtol=1e-6)
    eye = P.astype(np.float64) @ P_inv
    eye /= np.trace(eye, axis1=-2, axis2=-1)[..., None, None] / 3
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-3)
    again = camera_movie.camera_rows(5, SEED, 192)
    assert np.array_equal(again[0], P) and not np.array_equal(P[0], P[1])


def test_work_counts():
    """112.0 GFLOP a sample: four views of the flagship's 26.37 and a
    middle of 6.56; the bounds of one chunk: B1 and B2 at four times the
    rows, ftl_fusion by its operations."""
    spec = json.loads((ROOT / f"portbench/configs/{CONFIG}.json").read_text())
    pix = 48 * 48
    mid = 2.0 * pix * (4 * 256 * 300 + 1600 * 400 + 400 * 400 + 4 * 300 * 256) + \
        2 * 4 * 2.0 * pix * 100 * 12
    assert disentangled.middle_ops(spec) == pytest.approx(mid, rel=1e-12)
    assert mid == pytest.approx(6.56e9, rel=1e-3)
    assert disentangled.flops_per_frame(spec) == pytest.approx(
        4 * basicnet.flops_per_frame(disentangled.view_spec(spec)) + mid, rel=1e-12)
    assert disentangled.flops_per_frame(spec) == pytest.approx(112.0e9, rel=1e-3)
    b = disentangled.kernel_bounds(spec, 256)
    flagship = json.loads((ROOT / "portbench/configs/basicnet_flagship.json").read_text())
    want = basicnet.kernel_bounds(flagship, 1024)
    for op in ("pose_estimation::fused_encoder_stage", "pose_estimation::fused_decoder"):
        assert b[op] == pytest.approx(want[op], rel=1e-12)
    assert b["pose_estimation::ftl_fusion"] == [work.bound_s(256 * mid, 0)]


def _fails(cell, numbers: dict) -> bool:
    return any(numbers[n] > limit for n, limit in cell.limits.items())


def test_control_fails_the_limits(tiny):
    c = tiny.cell(CELL)
    for seed in (SEED, SEED + 1, SEED + 2):
        driver = manifest.module("drivers", c.traffic["driver"]).Driver(
            harness.context(c, seed, "cpu"))
        harness.window(driver, 0.2, None, 0, 0)
        driver.release()
        assert not _fails(c, driver.numbers())
        assert _fails(c, driver.control_numbers())


def _patch_ftl(monkeypatch, change):
    """``ftl_fusion`` as the fused forward calls it, its arguments changed
    by ``change(args) -> args`` first."""
    from pose_estimation_amitai_torch.ops import custom_ops

    orig = custom_ops.ftl_fusion
    monkeypatch.setattr(custom_ops, "ftl_fusion", lambda *a: orig(*change(list(a))))


def _p_for_p_inv(monkeypatch):
    """The inverse FTL takes P, transposed to P_inv's shape, in P_inv's
    place."""
    def change(a):
        a[2] = a[1].transpose(-2, -1).contiguous()
        return a

    _patch_ftl(monkeypatch, change)


def _another_samples_cameras(monkeypatch):
    """Each sample of a chunk takes the next sample's cameras."""
    def change(a):
        a[1], a[2] = a[1].roll(1, 0), a[2].roll(1, 0)
        return a

    _patch_ftl(monkeypatch, change)


def _running_averages_ignored(monkeypatch):
    """Each BatchNorm normalises with mean 0 and variance 1, the averages a
    fresh module holds, in place of the loaded ones."""
    def change(a):
        for i in (11, 12, 13):
            bn = a[i].clone()
            bn[2], bn[3] = 0.0, 1.0
            a[i] = bn
        return a

    _patch_ftl(monkeypatch, change)


def _two_views_swapped(monkeypatch):
    """The decoder's maps of views 0 and 1 of each sample trade places."""
    from pose_estimation_amitai_torch.ops import custom_ops

    orig = custom_ops.fused_decoder

    def swapped(*a):
        out = orig(*a)
        v = out.view(-1, 4, *out.shape[1:])
        return v[:, [1, 0, 2, 3]].reshape(out.shape)

    monkeypatch.setattr(custom_ops, "fused_decoder", swapped)


FAULTS = [_p_for_p_inv, _another_samples_cameras, _two_views_swapped,
          _running_averages_ignored]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_a_fault_underneath_a_run_is_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    r = harness.run_cell(tiny, tiny.cell(CELL), SEED, 0.3, False, "cpu", 0.0)
    assert r["correct"] is False, r["checks"]


def test_the_reference_imports_nothing_of_the_port():
    for f in ("families/disentangled.py",):
        text = (ROOT / "portbench" / f).read_text()
        assert "pose_estimation_amitai" not in text.replace('"pose_estimation::', ""), f
