"""The port's own spans and counters in a traced run
(``pose_estimation_amitai_torch.tracing``): per ``pe.`` span its count and
host seconds inside the traced stretch, the device's idle time in it put
down to the innermost ``pe.`` span the host was in, and the staging
counters.

A reader gets the run's :class:`~portbench.trace.TraceSummary`, which does
not carry the profiler's events; :func:`of` takes them from the
:class:`~portbench.trace.Tracer` that made the summary, found on the
reading harness's call stack (the frame that holds both). The busy
intervals are ``trace.py``'s: every CUDA activity but the profiler's
bookkeeping and annotations' device ranges, cut to the stretch. Counters
are never reset, so their values at reading are the run's (the set-up's
warm-up included). Against a program without ``tracing`` (or spans) every
reading is empty, and the readers give None.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from dataclasses import dataclass, field

from torch.autograd import DeviceType

from .trace import _OVERHEAD, WINDOW, Tracer, merged

PREFIX = "pe."
OUTSIDE = "outside pe spans"


@dataclass
class Spans:
    window_s: float
    busy_s: float
    spans: dict = field(default_factory=dict)  # name -> [count, host seconds]
    idle_by_span: dict = field(default_factory=dict)  # innermost span -> idle seconds
    counts: dict | None = None  # tracing.counts() at reading, None without them

    def seconds(self, *names: str) -> float:
        return sum(self.spans.get(n, (0, 0.0))[1] for n in names)

    def count(self, name: str) -> int:
        return self.spans.get(name, (0, 0.0))[0]

    def idle(self, *names: str) -> float:
        return sum(self.idle_by_span.get(n, 0.0) for n in names)


_last: tuple = (None, None)  # (summary, its Spans): the events are scanned once a run


def of(t) -> Spans | None:
    """The spans of the traced run summarised by ``t``; None where no
    tracer that made ``t`` is on the call stack."""
    global _last
    if _last[0] is t:
        return _last[1]
    tracer = _tracer_of(t)
    if tracer is None:
        return None
    s = from_events(tracer._prof.events())
    s.counts = _counts()
    _last = (t, s)
    return s


def describe(s: Spans) -> str:
    """One line for a run's standard error: the idle partition and the
    counters."""
    idle = {k: round(v, 6) for k, v in sorted(s.idle_by_span.items(), key=lambda kv: -kv[1])}
    return (f"idle by span (s, of {s.window_s - s.busy_s:.6f} idle in {s.window_s:.6f}): "
            f"{idle}; counts {s.counts}")


def _tracer_of(t) -> Tracer | None:
    f = sys._getframe(1)
    while f is not None:
        local = f.f_locals.values()
        if any(v is t for v in local):
            for v in local:
                if isinstance(v, Tracer):
                    return v
        f = f.f_back
    return None


def _counts() -> dict | None:
    try:
        from pose_estimation_amitai_torch import tracing
    except ImportError:
        return None
    return tracing.counts()


def from_events(events) -> Spans:
    """Spans of profiler ``events`` inside the ``trace.WINDOW`` mark's
    stretch (microsecond times)."""
    marks = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not marks:
        return Spans(0.0, 0.0)
    w0, w1 = marks[0].time_range.start, marks[0].time_range.end
    busy, spans = [], []
    for e in events:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        if e.device_type == DeviceType.CUDA:
            if e.name not in _OVERHEAD and not getattr(e, "is_user_annotation", False):
                busy.append((s, t))
        elif e.device_type == DeviceType.CPU and e.name.startswith(PREFIX):
            spans.append((s, t, e.name))
    busy = merged(busy)
    table: dict = defaultdict(lambda: [0, 0.0])
    for s, t, name in spans:
        table[name][0] += 1
        table[name][1] += (t - s) * 1e-6
    idle = {k: v * 1e-6 for k, v in idle_by_span(busy, spans, w0, w1).items()}
    return Spans(window_s=(w1 - w0) * 1e-6, busy_s=sum(t - s for s, t in busy) * 1e-6,
                 spans={k: list(v) for k, v in table.items()}, idle_by_span=idle)


def innermost(spans: list, w0: float, w1: float) -> list:
    """``[(start, end, name)]`` tiling [w0, w1]: in each piece the innermost
    of ``spans`` (``(start, end, name)``, nested as a call stack nests them:
    the latest started of those around it) or :data:`OUTSIDE`."""
    cuts = sorted({w0, w1, *(x for s, t, _ in spans for x in (s, t) if w0 < x < w1)})
    by_start = sorted(spans)
    out, active, j = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while j < len(by_start) and by_start[j][0] <= a:
            active.append(by_start[j])
            j += 1
        active = [sp for sp in active if sp[1] > a]
        name = max(active, key=lambda sp: (sp[0], -sp[1]))[2] if active else OUTSIDE
        if out and out[-1][2] == name and out[-1][1] == a:
            out[-1] = (out[-1][0], b, name)
        else:
            out.append((a, b, name))
    return out


def idle_by_span(busy: list, spans: list, w0: float, w1: float) -> dict:
    """The idle time of [w0, w1] (what the merged, sorted ``busy``
    intervals leave) by the innermost span around it: the exact
    intersection of each idle interval with each piece of
    :func:`innermost`. The values sum to the window less the busy time."""
    idle, at = [], w0
    for s, t in busy:
        if s > at:
            idle.append((at, min(s, w1)))
        at = max(at, t)
    if at < w1:
        idle.append((at, w1))
    out: dict = defaultdict(float)
    pieces = innermost(spans, w0, w1)
    i = 0
    for s, t in idle:
        while i < len(pieces) and pieces[i][1] <= s:
            i += 1
        k = i
        while k < len(pieces) and pieces[k][0] < t:
            a, b = max(s, pieces[k][0]), min(t, pieces[k][1])
            if b > a:
                out[pieces[k][2]] += b - a
            k += 1
    return dict(out)
