"""Where the serving time goes on the card: one traced ``Predictor`` call
per route, at the flagship configuration.

    python -m pose_estimation_amitai_torch.profile_routes [--frames 512] [--out FILE]

For each route (``"fused"``, the hand-written kernels; ``"module"``, the
``nn.Module`` forward) at ``Config()`` defaults (filters 64, bf16,
192x192x4 frames -> 18 maps, chunk 256, seeded random weights): one warm-up
call, one call on ``--frames`` frames timed on the host clock, then the
same call under ``torch.profiler``. Prints one JSON object (and writes it to
``--out`` if given): the card's ``nvidia-smi`` name and power limit, and
for each route the wall seconds untraced and traced, the device's busy time
(the union of its activity intervals) and busy share of the traced wall,
host-to-device copy time, and device time by kernel name. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType

from . import weights
from .config import Config
from .infer import Predictor

SEED = 0
SHAPE = (192, 192, 4)
K = 18
TOP = 12  # kernel names listed per route
NAME_CHARS = 160  # of a kernel name: templated names run to 1,000 and more
_OVERHEAD = {"Activity Buffer Request"}  # profiler bookkeeping, not work


def _union_us(spans: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_route(cfg: Config, params, frames: np.ndarray, use_fused: bool) -> dict:
    pred = Predictor(cfg, params, SHAPE, K, device="cuda", use_fused=use_fused)
    pred(frames[: pred.chunk_size])  # warm-up: kernel load, allocator
    t0 = time.perf_counter()
    pred(frames)
    untraced = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pred(frames)  # ends in a device-to-host copy, which synchronises
        traced = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and e.name not in _OVERHEAD]
    if not dev:
        raise RuntimeError("the profiler traced no device activity")
    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in dev])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "serving_path": pred.serving_path, "frames": len(frames),
        "chunk_size": pred.chunk_size,
        "wall_s_untraced": untraced, "wall_s_traced": traced,
        "device_busy_us": busy_us, "device_busy_share": busy_us * 1e-6 / traced,
        "htod_us": sum(v[0] for n, v in by_name.items() if "HtoD" in n),
        "device_us_by_name": [
            {"name": n[:NAME_CHARS], "us": v[0], "count": v[1]} for n, v in top
        ],
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_routes: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = Config()
    params = weights.init_basicnet_params(
        np.random.default_rng(SEED), SHAPE[-1], K, filters=cfg.num_base_filters)
    frames = np.random.default_rng(SEED).random((args.frames, *SHAPE), dtype=np.float32)
    out = {"nvidia_smi": smi}
    for route, use_fused in (("fused", True), ("module", False)):
        out[route] = profile_route(cfg, params, frames, use_fused)
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
