"""The traced part of a run: ``torch.profiler`` over a stretch of the
window, reduced to device intervals, per-op device time and a breakdown.

``union_s`` is the device-interval arithmetic of the port's
``profile_routes.py`` (``_union_us``), kept here so that the yardstick does
not move with the program. Device work is every CUDA activity the profiler
records (kernels, copies, sets) except its own bookkeeping and the device
ranges of annotations. A custom op's device time is what the profiler
attributes to its CPU event (``device_time_total``: the kernels launched
inside it, its helpers' included).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType

WINDOW = "portbench.traced_window"
_OVERHEAD = {"Activity Buffer Request"}  # profiler bookkeeping, not work
TOP = 10  # entries of each breakdown list
NAME_CHARS = 120


def union_s(spans: list[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` spans."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def merged(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class TraceSummary:
    """What the readers of per-layer metrics read. Seconds throughout."""

    window_s: float  # the traced stretch, by the trace's own clock
    busy_s: float  # union of device activity inside it
    compute_s: float  # union of device activity other than host-to-device copies
    units: int  # calls, clips or steps inside the traced stretch
    useful: int  # unpadded frames served or samples trained inside it
    work: dict  # the family's counts: flops per useful frame or sample, kernel bounds
    op_calls: dict = field(default_factory=dict)  # custom op name -> calls
    op_device_s: dict = field(default_factory=dict)  # custom op name -> device seconds
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def roofline_pct(t: TraceSummary, op: str) -> float | None:
    """``op``'s calls' bound seconds over the device seconds attributed to
    it, in %; None where the stretch has no call of it, or the profiler
    attributed it no device time. ``work["kernel_bounds"][op]`` holds the
    bound of each of its calls in one chunk's forward, in order."""
    bounds = t.work.get("kernel_bounds", {}).get(op)
    calls, dev = t.op_calls.get(op, 0), t.op_device_s.get(op, 0.0)
    if not bounds or not calls or dev <= 0 or calls % len(bounds):
        return None
    return 100.0 * sum(bounds) * (calls // len(bounds)) / dev


class Tracer:
    """``start()`` and ``stop()`` around a stretch of the window; the caller
    synchronises the device before ``stop()``."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._mark = None
        self.wall_s = 0.0

    def start(self) -> None:
        self._prof.__enter__()
        self._mark = torch.autograd.profiler.record_function(WINDOW)
        self._mark.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self.wall_s = time.perf_counter() - self._t0
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def summary(self, units: int, useful: int, work: dict) -> TraceSummary:
        events = self._prof.events()
        marks = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
        if marks:
            w0, w1 = marks[0].time_range.start, marks[0].time_range.end
        else:
            w0, w1 = float("-inf"), float("inf")
        dev, cpu = [], []
        for e in events:
            if e.device_type == DeviceType.CUDA:
                if e.name not in _OVERHEAD and not getattr(e, "is_user_annotation", False):
                    s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
                    if t > s:
                        dev.append((s, t, e.name))
            elif e.name != WINDOW:
                cpu.append(e)
        spans = [(s, t) for s, t, _ in dev]
        busy = union_s(spans)
        compute = union_s([(s, t) for s, t, n in dev if "HtoD" not in n])
        window_us = (w1 - w0) if marks else self.wall_s * 1e6
        op_names = set(work.get("kernel_bounds", {}))
        calls: dict[str, int] = defaultdict(int)
        dev_s: dict[str, float] = defaultdict(float)
        for e in cpu:
            if e.name in op_names and not _under(e, e.name):
                calls[e.name] += 1
                dev_s[e.name] += _device_us(e) * 1e-6
        by_name: dict[str, float] = defaultdict(float)
        for s, t, n in dev:
            by_name[n] += (t - s) * 1e-6
        top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return TraceSummary(
            window_s=window_us * 1e-6, busy_s=busy * 1e-6, compute_s=compute * 1e-6,
            units=units, useful=useful, work=work, op_calls=dict(calls),
            op_device_s={k: v for k, v in dev_s.items() if v > 0},
            device_ops=[[n[:NAME_CHARS], v] for n, v in top_ops],
            idle_gaps=_idle_gaps(merged(spans), cpu, w0, w1) if marks else [],
        )


def _under(e, name: str) -> bool:
    p = e.cpu_parent
    while p is not None:
        if p.name == name:
            return True
        p = p.cpu_parent
    return False


def _device_us(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _idle_gaps(busy: list, cpu: list, w0: float, w1: float) -> list:
    """The device's idle time inside the window, summed by what the host was
    doing at each gap's middle (the innermost host event around it)."""
    edges = [w0]
    for s, e in busy:
        edges += [s, e]
    edges.append(w1)
    cpu = sorted(cpu, key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in cpu]
    by_what: dict[str, float] = defaultdict(float)
    for i in range(0, len(edges), 2):
        g0, g1 = edges[i], edges[i + 1]
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        what = "host outside any traced op"
        j = bisect.bisect_right(starts, mid) - 1
        for k in range(j, max(j - 400, -1), -1):
            if cpu[k].time_range.end >= mid:
                what = cpu[k].name
                break
        by_what[what[:NAME_CHARS]] += (g1 - g0) * 1e-6
    return [[n, v] for n, v in sorted(by_what.items(), key=lambda kv: -kv[1])[:TOP]]
