"""The port's profiler spans and staging counters (``tracing.py``) on the
CPU: a 48x48 BasicNet at filters 8 served at chunk 16, and one train step.

With no profiler running a span is the shared no-op and the program's
results are those it gives under a profiler; under ``torch.profiler`` each
span appears once per unit of work, nested by the host's call stack; the
counters count every chunk staged; an exported program holds no profiler
node even when exported under a profiler."""

import io
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from pose_estimation_amitai_torch import deploy, tracing, weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.infer import Predictor
from pose_estimation_amitai_torch.models import build_model
from pose_estimation_amitai_torch.train import loop

SHAPE = (48, 48, 4)
K = 6
CHUNK = 16
CFG = Config(num_base_filters=8, compute_dtype="float32")
PACKAGE = Path(tracing.__file__).resolve().parent


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    frames = rng.random((40, *SHAPE)).astype(np.float32)
    params = weights.init_basicnet_params(rng, SHAPE[-1], K, filters=8)
    pred = Predictor(CFG, params, SHAPE, K, device="cpu", chunk_size=CHUNK)
    pred(frames[:CHUNK])  # first call's one-off work outside the traces
    return frames, pred


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _pe(events) -> list[tuple[str, str | None]]:
    """(span, its innermost enclosing span or None) of every ``pe.`` host
    event, in start order."""
    out = []
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.device_type != DeviceType.CPU or not e.name.startswith(tracing.PREFIX):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(tracing.PREFIX):
            p = p.cpu_parent
        out.append((e.name, p.name if p is not None else None))
    return out


def test_off_is_one_shared_no_op_and_changes_nothing(setup, monkeypatch):
    frames, pred = setup
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("pe.call") is tracing.span("pe.stage")
    opened = []
    real = torch.autograd.profiler.record_function
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda *a, **k: opened.append(a) or real(*a, **k))
    off = pred(frames)
    off_movie = pred.predict_movie(frames, prefetch=2)
    assert not [a for a in opened if str(a[0]).startswith(tracing.PREFIX)]
    on, events = _profiled(lambda: pred(frames))
    assert [a[0] for a in opened if str(a[0]).startswith(tracing.PREFIX)][:2] == [
        "pe.call", "pe.stage"]
    assert np.array_equal(off, on) and np.array_equal(off_movie, off)
    assert _pe(events)


@pytest.mark.parametrize("entry, want", [
    ("call", {("pe.call", None): 1, ("pe.stage", "pe.call"): 3,
              ("pe.stage.fill", "pe.stage"): 3, ("pe.forward", "pe.call"): 3,
              ("pe.decode", "pe.call"): 3, ("pe.fetch", "pe.call"): 3}),
    # two whole chunks in flight, then the 8-frame tail through __call__
    ("movie", {("pe.movie", None): 1, ("pe.stage", "pe.movie"): 2,
               ("pe.stage.fill", "pe.stage"): 3, ("pe.forward", "pe.movie"): 2,
               ("pe.decode", "pe.movie"): 2, ("pe.call", "pe.movie"): 1,
               ("pe.stage", "pe.call"): 1, ("pe.forward", "pe.call"): 1,
               ("pe.decode", "pe.call"): 1, ("pe.fetch", "pe.call"): 1}),
])
def test_spans_nest_as_the_host_calls(setup, entry, want):
    frames, pred = setup
    fn = {"call": lambda: pred(frames), "movie": lambda: pred.predict_movie(frames, 2)}[entry]
    before = tracing.counts()
    out, events = _profiled(fn)
    after = tracing.counts()
    assert out.shape == (40, 3, K)
    assert Counter(_pe(events)) == want
    # 40 frames at chunk 16: three chunks, the last padded by 8 zero rows
    assert {k: after[k] - before[k] for k in after} == {"stage.rows": 40, "stage.padded_rows": 8}


def test_train_step_spans_nest():
    cfg = Config(num_base_filters=8, compute_dtype="float32", dropout_ratio=0.0,
                 do_augmentations=False, accumulation_steps=2)
    model = build_model(cfg, SHAPE, K)
    state = loop.create_train_state(model, cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    data = {"box": torch.from_numpy(rng.random((8, *SHAPE), np.float32)),
            "peaks": torch.from_numpy(rng.uniform(4, 44, (8, K, 2)).astype(np.float32)),
            "peak_vals": torch.from_numpy(rng.uniform(0.5, 1, (8, K)).astype(np.float32))}
    step = loop.make_train_step(model, cfg)
    (new, loss), events = _profiled(lambda: step(state, data, np.arange(8).reshape(2, 4)))
    assert new.step == 1 and torch.isfinite(loss)
    assert Counter(_pe(events)) == {
        ("pe.train.step", None): 1, ("pe.train.batch", "pe.train.step"): 2,
        ("pe.train.grads", "pe.train.step"): 2, ("pe.train.adam", "pe.train.step"): 1}


def test_export_under_a_profiler_holds_no_profiler_node(setup, tmp_path):
    _, pred = setup
    path = str(tmp_path / "m.ptexp")
    _profiled(lambda: deploy.export_predictor(pred, path))
    _, blob = deploy.read_artifact(path)
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes]
    assert any("conv" in t for t in targets)
    assert not [t for t in targets if "profiler" in t or "record_function" in t]


def test_every_span_in_the_package_is_documented():
    used = set()
    for f in PACKAGE.rglob("*.py"):
        used |= set(re.findall(r'span\("(pe\.[a-z.]+)"\)', f.read_text()))
    assert used == set(tracing.SPANS)
    for name in tracing.SPANS:
        assert f"``{name}``" in tracing.__doc__
