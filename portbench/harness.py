"""One run of one cell: set-up, the measured window, the check that decides
``correct``, and the result line.

The window runs the driver's units back to back for ``seconds`` of the host
clock, and closes on the first unit that ends past it (then a synchronise):
its rates are all the work over all the time. With ``trace``, the
profiler covers ``trace_units`` units of the window after the first
``trace_skip``, and the per-layer readers read that stretch; the
end-to-end metrics are then not reported.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass
from types import ModuleType

import torch

from . import manifest
from .trace import Tracer

FORBIDDEN = {"jax", "jaxlib", "flax", "pose_estimation_amitai_tpu"}


@dataclass
class Ctx:
    spec: dict
    traffic: dict
    seed: int
    device: torch.device
    family: ModuleType


def context(cell: manifest.Cell, seed: int, device) -> Ctx:
    return Ctx(spec=cell.config, traffic=cell.traffic, seed=int(seed),
               device=torch.device(device), family=manifest.module("families",
                                                                    cell.config["family"]))


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    jaxlib's, flax's or the JAX package's."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def window(driver, seconds: float, tracer: Tracer | None, skip: int, units: int):
    """(window_s, units done, useful done, (traced units, traced useful))."""
    t0 = time.perf_counter()
    done = useful = 0
    traced = (0, 0)
    while True:
        if tracer is not None and done == skip:
            tracer.start()
            traced_from = useful
        useful += driver.unit()
        done += 1
        if tracer is not None and done == skip + units:
            driver.sync()
            tracer.stop()
            traced = (units, useful - traced_from)
        if time.perf_counter() - t0 >= seconds and (tracer is None or done >= skip + units):
            break
    driver.sync()
    return time.perf_counter() - t0, done, useful, traced


def run_cell(bench: manifest.Manifest, cell: manifest.Cell, seed: int, seconds: float,
             trace: bool, device, t_start: float) -> dict:
    """Run ``cell`` once; returns the result object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
    traced, and ``checks``: each number compared beside its limit)."""
    ctx = context(cell, seed, device)
    t_driver = time.perf_counter()
    driver = manifest.module("drivers", cell.traffic["driver"]).Driver(ctx)
    driver.sync()
    setup_s = time.perf_counter() - t_start
    print(f"setup {setup_s:.3f} s: {t_driver - t_start:.3f} s to the driver's set-up",
          file=sys.stderr)
    tracer = Tracer(ctx.device) if trace else None
    window_s, done, useful, traced = window(
        driver, seconds, tracer, cell.traffic.get("trace_skip", 1),
        cell.traffic.get("trace_units", 1))
    dev = device_info(ctx.device)
    metrics: dict = {}
    breakdown = None
    if trace:
        summary = tracer.summary(traced[0], traced[1], driver.work())
        print(f"traced {summary.units} units, {summary.useful} useful; custom ops: calls "
              f"{summary.op_calls}, device s {summary.op_device_s}", file=sys.stderr)
        for m in cell.per_layer:
            value = bench.reader(m["name"]).read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        breakdown = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    else:
        values = {**driver.end_to_end(window_s, useful), "setup_s": setup_s}
        for m in cell.end_to_end:
            # a metric split by cell (serve_fps.vit) is its base quantity
            value = values.get(m["name"], values.get(m["name"].split(".")[0]))
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    driver.release()
    numbers = driver.numbers()
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in cell.limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    out = {"correct": correct, "attempted": done, "failed": 0, "metrics": metrics,
           "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
