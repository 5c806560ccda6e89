"""CPU tests of the readers of the port's own spans and counters
(``portbench/spans.py`` and the ``stage_fill_ms``, ``stage_idle_pct``,
``padded_rows_pct`` and ``dispatch_ms`` readers).

Run them with ``python -m pytest portbench -m '' -p no:cacheprovider``.
"""

from __future__ import annotations

import contextlib
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness, manifest, spans
from portbench.test_portbench_harness import ROOT, SEED
from portbench.tiny import tiny_manifest
from portbench.trace import WINDOW, TraceSummary, Tracer

NEW = ["stage_fill_ms", "stage_fill_ms.clips", "stage_idle_pct", "stage_idle_pct.clips",
       "padded_rows_pct.clips", "dispatch_ms", "dispatch_ms.clips"]

# a stretch of 100 us: spans nested as a call nests them, the device busy
# in [0, 5], [20, 60] and [70, 80]
SPANS = [(10, 90, "pe.call"), (10, 30, "pe.stage"), (12, 25, "pe.stage.fill"),
         (30, 50, "pe.forward"), (50, 88, "pe.fetch")]
BUSY = [(0, 5), (20, 60), (70, 80)]
# the gap [5, 20] straddles no span, pe.stage and pe.stage.fill; [80, 100]
# pe.fetch, pe.call and no span
IDLE = {"outside pe spans": 15, "pe.stage": 2, "pe.stage.fill": 8, "pe.fetch": 18,
        "pe.call": 2}


def test_idle_by_span_partitions_the_idle_time():
    got = spans.idle_by_span(BUSY, SPANS, 0, 100)
    assert got == pytest.approx(IDLE)
    assert sum(got.values()) == pytest.approx(100 - sum(t - s for s, t in BUSY))
    # nothing busy: the pieces of innermost() themselves
    pieces = spans.innermost(SPANS, 0, 100)
    assert pieces[0] == (0, 10, "outside pe spans") and pieces[-1] == (90, 100,
                                                                        "outside pe spans")
    assert sum(b - a for a, b, _ in pieces) == 100
    assert spans.idle_by_span([], SPANS, 0, 100)["pe.forward"] == 20


def _event(name, s, t, device=DeviceType.CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=s, end=t))


def _events(with_spans=True):
    """Microseconds: the window mark at [1000, 1100], the spans and busy
    intervals above shifted into it, a host op inside the fill (no span),
    an annotation's device range (not work) and a kernel that starts before
    the window (cut to it)."""
    ev = [_event(WINDOW, 1000, 1100), _event("aten::copy_", 1013, 1020)]
    if with_spans:
        ev += [_event(n, 1000 + s, 1000 + t) for s, t, n in SPANS]
        ev.append(_event("pe.stage", 1010, 1030, DeviceType.CUDA, annotation=True))
    ev += [_event("kernel", 1000 + s, 1000 + t, DeviceType.CUDA) for s, t in BUSY[1:]]
    ev.append(_event("kernel", 900, 1005, DeviceType.CUDA))
    return ev


def _without_tracing(monkeypatch):
    """As if the program had no ``tracing`` module."""
    import pose_estimation_amitai_torch as port

    monkeypatch.delattr(port, "tracing")
    monkeypatch.setitem(sys.modules, "pose_estimation_amitai_torch.tracing", None)


def _read(names, events, monkeypatch, counts=(75, 25), scans=None):
    """Each reader's reading of a summary made by a tracer holding
    ``events``, read the way the harness reads it; each scan of the events
    appends to ``scans``."""
    from pose_estimation_amitai_torch.infer import FrameStager

    for attr, v in zip(("frames", "padded_rows"), counts):
        monkeypatch.setattr(FrameStager, attr, v)
    scans = [] if scans is None else scans
    tracer = Tracer(torch.device("cpu"))
    tracer._prof = SimpleNamespace(events=lambda: scans.append(1) or events)
    summary = TraceSummary(window_s=100e-6, busy_s=55e-6, compute_s=55e-6, units=1,
                           useful=1, work={})
    bench = manifest.Manifest(ROOT / "BENCHMARK.json")
    return {n: bench.reader(n).read(summary) for n in names}


def test_readers_on_a_synthetic_trace(monkeypatch, capsys):
    scans = []
    got = _read(NEW, _events(), monkeypatch, scans=scans)
    assert len(scans) == 1  # every reader of one summary shares one scan
    assert got["stage_fill_ms"] == got["stage_fill_ms.clips"] == pytest.approx(13e-3)
    assert got["stage_idle_pct"] == got["stage_idle_pct.clips"] == pytest.approx(10.0)
    assert got["padded_rows_pct.clips"] == pytest.approx(25.0)
    assert got["dispatch_ms"] == got["dispatch_ms.clips"] == pytest.approx(20e-3)
    assert capsys.readouterr().err.count("idle by span") == 2  # one a stage_idle_pct reader


def test_readers_without_the_ports_spans_give_none(monkeypatch):
    # no tracer on the stack
    bench = manifest.Manifest(ROOT / "BENCHMARK.json")
    t = TraceSummary(window_s=1.0, busy_s=0.5, compute_s=0.5, units=1, useful=1, work={})
    assert all(bench.reader(n).read(t) is None for n in NEW)
    # a program with neither spans nor counters, as before they existed
    _without_tracing(monkeypatch)
    assert _read(NEW, _events(with_spans=False), monkeypatch) == {n: None for n in NEW}


def test_manifest_with_the_new_entries():
    bench = manifest.Manifest(ROOT / "BENCHMARK.json")
    assert bench.problems() == []
    entries = {m["name"]: m for m in bench.data["per_layer"]}
    assert [m["name"] for m in bench.data["per_layer"]][-len(NEW):] == NEW
    for name in NEW:
        m = entries[name]
        assert m["source"] in ("program_span", "program_counter")
        assert m["workloads"] == (["basicnet.clips"] if name.endswith(".clips")
                                  else ["basicnet.movie"])
        assert bench.reader(name).read is not None


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_manifest(tmp_path_factory.mktemp("tiny"))


def test_a_traced_clips_run_reads_every_new_metric(tiny, monkeypatch):
    read, of = [], spans.of
    monkeypatch.setattr(spans, "of", lambda t: read.append(of(t)) or read[-1])
    c = tiny.cell("basicnet.clips")
    r = harness.run_cell(tiny, c, SEED, 0.3, True, "cpu", 0.0)
    want = [n for n in NEW if n.endswith(".clips")]
    assert set(want) <= set(r["metrics"])
    s = read[-1]
    idle = (1 - r["device"]["busy_s"] / r["device"]["window_s"]) * r["device"]["window_s"]
    assert abs(sum(s.idle_by_span.values()) - idle) <= 0.005 * r["device"]["window_s"]
    assert 0 < r["metrics"]["padded_rows_pct.clips"]["value"] < 100


def test_a_program_without_spans_runs_and_reports_none_of_them(tiny, monkeypatch):
    """The benchmark laid over a program from before the spans: the traced
    run still ends, and leaves the new metrics out."""
    from pose_estimation_amitai_torch import infer

    monkeypatch.setattr(infer, "span", lambda name: contextlib.nullcontext())
    _without_tracing(monkeypatch)
    r = harness.run_cell(tiny, tiny.cell("basicnet.clips"), SEED, 0.3, True, "cpu", 0.0)
    assert r["correct"] and "device_idle_pct.clips" in r["metrics"]
    assert not set(NEW) & set(r["metrics"])
