"""``correct`` has to come out false when it should: the control (the plain
reference computed in fp8 put in the program's place) and each fault a
cell can have, planted in the port underneath a run, at the size of
``portbench.tiny`` on the CPU. (The same control at the cells' own size on
the card: ``portbench/calibrate.py``.)"""

from __future__ import annotations

import pytest
import torch

from portbench import harness, manifest
from portbench.tiny import tiny_manifest, window_seconds

SEED = 2**31 + 987
SERVING = ["basicnet.movie", "vit.movie", "basicnet.clips"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_manifest(tmp_path_factory.mktemp("tiny"))


def _fails(cell, numbers: dict) -> bool:
    return any(numbers[n] > limit for n, limit in cell.limits.items())


@pytest.mark.parametrize("cell", [*SERVING, "basicnet.train"])
def test_control_fails_the_limits(tiny, cell):
    c = tiny.cell(cell)
    for seed in (SEED, SEED + 1, SEED + 2):
        driver = manifest.module("drivers", c.traffic["driver"]).Driver(
            harness.context(c, seed, "cpu"))
        harness.window(driver, window_seconds(cell, 0.2), None, 0, 0)
        driver.release()
        assert not _fails(c, driver.numbers())
        assert _fails(c, driver.control_numbers())


def _alter_an_answer(monkeypatch):
    """One decoded peak of every chunk moved half a frame away, where the
    port produces it."""
    from pose_estimation_amitai_torch.ops import peaks

    orig = peaks.find_peaks_with_vals

    def altered(maps):
        p = orig(maps).clone()
        p[0, 0, 0] = (p[0, 0, 0] + maps.shape[2] // 2) % maps.shape[2]
        return p

    monkeypatch.setattr(peaks, "find_peaks_with_vals", altered)


def _leave_out_half_the_chunk(monkeypatch):
    """The forward computes the first half of each chunk and hands the
    second half the first half's maps."""
    from pose_estimation_amitai_torch.infer import Predictor

    orig = Predictor.forward

    def half(self, frames, *cams):
        h = frames.shape[0] // 2
        maps = orig(self, frames[:h], *(c[:h] for c in cams))
        return torch.cat([maps, maps[: frames.shape[0] - h]])

    monkeypatch.setattr(Predictor, "forward", half)


def _state_unchanged(monkeypatch):
    """Adam's update returns the parameters as they were."""
    from pose_estimation_amitai_torch.train import loop

    orig = loop.adam_step

    def unchanged(params, opt_state, grads, lr):
        _, opt = orig(params, opt_state, grads, lr)
        return {k: v.detach().clone() for k, v in params.items()}, opt

    monkeypatch.setattr(loop, "adam_step", unchanged)


def _half_the_batch(monkeypatch):
    """The loss is the mean over the first half of each batch only."""
    from pose_estimation_amitai_torch.train import loop

    orig = loop.make_loss_fn

    def make(cfg):
        fn = orig(cfg)
        return lambda pred, target: fn(pred[: pred.shape[0] // 2],
                                       target[: target.shape[0] // 2])

    monkeypatch.setattr(loop, "make_loss_fn", make)


def _warp_the_wrong_way(monkeypatch):
    """The augmentation warps each frame by the inverse of its matrix, so
    frames and targets no longer move together."""
    from pose_estimation_amitai_torch.ops import affine

    orig = affine.affine_warp_separable_batch

    def wrong(images, mats, order=1, shear_limit=1.0):
        return orig(images, torch.linalg.inv(mats), order, shear_limit=shear_limit)

    monkeypatch.setattr(affine, "affine_warp_separable_batch", wrong)


FAULTS = [(c, f) for c in SERVING for f in (_alter_an_answer, _leave_out_half_the_chunk)] + [
    ("basicnet.train", f) for f in (_state_unchanged, _half_the_batch, _warp_the_wrong_way)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_fault_underneath_a_run_is_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = harness.run_cell(tiny, tiny.cell(cell), SEED, window_seconds(cell, 0.3), False, "cpu",
                         0.0)
    assert r["correct"] is False, r["checks"]
