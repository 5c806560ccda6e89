"""Where the time goes on the card: one traced ``Predictor`` call per
route, at the flagship configuration or at the default ViT's; or a run of
flagship train steps.

    python -m pose_estimation_amitai_torch.profile_routes [--model basicnet|vit|train]
        [--frames 512] [--routes fused module ...] [--out FILE]

``--model basicnet`` (the default): each route (``"fused"``, the
hand-written kernels; ``"module"``, the ``nn.Module`` forward;
``"int8_fused"`` and ``"int8_resident"``, the calibrated int8 forwards, the
first through the int8 stage kernel) at ``Config()`` defaults (filters 64,
bf16, 192x192x4 frames -> 18 maps, chunk 256, seeded random weights, int8
scales from the first 128 frames). ``--model vit``: ``"fused"`` (every
attention core on the attention kernel) and ``"module"`` (argmax peaks-only
serving, so the bf16 softmax chain) at ``Config(model_type=
MODEL_18_POINTS_PER_WING_VIT)`` (patch 16, dim 256, depth 8, heads 8,
dim_head 256, bf16, chunk 256, seeded random weights). Per route: one warm-up
call, one call on ``--frames`` frames timed on the host clock, then the
same call under ``torch.profiler``; then the same for ``predict_movie`` on
the same frames (``"predict_movie"``), whose chunks' copies overlap the
kernels of the chunks before them. ``--model train``: ``TRAIN_STEPS`` steps
of ``train.loop.make_train_step`` at ``Config()`` (batch 8, augmentation,
dropout, Adam) on the 128 per-wing samples of 16 synthetic frames, after 3
warm-up steps, timed, then traced the same way (``--frames`` and
``--routes`` do not apply). Prints one JSON object (and writes it to
``--out`` if given): the card's ``nvidia-smi`` name and power limit, and
for each route (and its ``predict_movie``) the wall seconds untraced and
traced, the device's busy time (the union of its activity intervals) and
busy share of the traced wall, host-to-device copy time, the busy time of
everything else (``compute_busy_us``: copy time hidden under it is
``htod_us + compute_busy_us - device_busy_us``), and device time by kernel
name. Needs a CUDA device.
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

from . import constants as C
from . import weights
from .config import Config
from .infer import Predictor

SEED = 0
SHAPE = (192, 192, 4)
K = 18
CALIB_FRAMES = 128  # int8 calibration set: 4 batches of 32
# Predictor options of each route
ROUTES = {
    "fused": dict(use_fused=True),
    "module": dict(),
    "int8_fused": dict(use_quantized=True, use_fused=True),
    "int8_resident": dict(use_quantized=True),
}
VIT_ROUTES = {"fused": dict(use_fused=True), "module": dict()}
TRAIN_STEPS = 10  # traced train steps
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


def model_setup(model: str) -> tuple[Config, dict, dict]:
    """(config, seeded flax-layout params, route options) of ``--model``."""
    rng = np.random.default_rng(SEED)
    if model == "vit":
        cfg = Config(model_type=C.MODEL_18_POINTS_PER_WING_VIT)
        params = weights.init_vit_params(
            rng, SHAPE[-1], K, SHAPE[0], patch_size=cfg.patch_size,
            dim=cfg.projection_dim, depth=cfg.transformer_layers,
            heads=cfg.num_heads, dim_head=cfg.projection_dim,
            mlp_expand=cfg.fully_connected_expand, kernel_size=cfg.kernel_size)
        return cfg, params, VIT_ROUTES
    cfg = Config()
    params = weights.init_basicnet_params(
        rng, SHAPE[-1], K, filters=cfg.num_base_filters)
    return cfg, params, ROUTES


def profile_route(
    cfg: Config, params, frames: np.ndarray, route: str, opts: dict,
) -> dict:
    opts = dict(opts)
    if opts.get("use_quantized"):
        opts["calibration_frames"] = frames[:CALIB_FRAMES]
    pred = Predictor(cfg, params, SHAPE, K, device="cuda", **opts)
    if pred.serving_path != route:
        raise RuntimeError(f"asked for {route!r}, got {pred.serving_path!r}")
    pred(frames[: pred.chunk_size])  # warm-up: kernel load, allocator
    # each call ends in a device-to-host copy, which synchronises
    return {"serving_path": pred.serving_path, "frames": len(frames),
            "chunk_size": pred.chunk_size, **_traced(lambda: pred(frames)),
            "predict_movie": _traced(lambda: pred.predict_movie(frames))}


def profile_train(steps: int) -> dict:
    """``steps`` flagship train steps at ``Config()``, after 3 warm-up steps."""
    from .data import build_dataset, make_synthetic_arrays
    from .models import build_model
    from .train import loop

    cfg = Config()
    arrays = make_synthetic_arrays(num_frames=16, num_points=2 * (K - 2),
                                   image_size=SHAPE[0], seed=SEED)
    ds, _ = build_dataset(cfg, arrays, device="cuda")
    with torch.device("meta"):
        model = build_model(cfg, SHAPE, K)
    step = loop.make_train_step(model, cfg)
    state = loop.create_train_state(model, cfg, seed=SEED, device="cuda")
    idx = [ds.step_indices(cfg.batch_size, cfg.accumulation_steps)
           for _ in range(3 + 2 * steps)]
    it = iter(idx)

    def run(n: int) -> None:
        nonlocal state
        for _ in range(n):
            state, loss = step(state, ds.data, next(it))
        torch.cuda.synchronize()

    run(3)  # warm-up: cuDNN plans, allocator
    return {"steps": steps, "batch": cfg.batch_size * cfg.accumulation_steps,
            **_traced(lambda: run(steps))}


def _traced(call) -> dict:
    """Host seconds of ``call()`` (which must synchronise), then the same
    under ``torch.profiler``: traced seconds, the device's busy time and
    share, host-to-device copy time and device time by kernel name."""
    t0 = time.perf_counter()
    call()
    untraced = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        traced = time.perf_counter() - t0
    # device work only: not the profiler's bookkeeping, nor the device-side
    # ranges of annotations such as ``Optimizer.step#Adam.step``
    dev = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and e.name not in _OVERHEAD
           and not getattr(e, "is_user_annotation", False)]
    if not dev:
        raise RuntimeError("the profiler traced no device activity")
    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in dev])
    compute_us = _union_us([(e.time_range.start, e.time_range.end) for e in dev
                            if "HtoD" not in e.name])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "wall_s_untraced": untraced, "wall_s_traced": traced,
        "device_busy_us": busy_us, "device_busy_share": busy_us * 1e-6 / traced,
        "htod_us": sum(v[0] for n, v in by_name.items() if "HtoD" in n),
        "compute_busy_us": compute_us,
        "device_us_by_name": [
            {"name": n[:NAME_CHARS], "us": v[0], "count": v[1]} for n, v in top
        ],
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("basicnet", "vit", "train"), default="basicnet")
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--routes", nargs="+", choices=list(ROUTES),
                    help="default: every route of the model")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    known = {"vit": VIT_ROUTES, "basicnet": ROUTES, "train": {}}[args.model]
    for route in args.routes or ():
        if route not in known:
            ap.error(f"--model {args.model} has no route {route!r}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_routes: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out = {"nvidia_smi": smi, "model": args.model}
    if args.model == "train":
        out["train"] = profile_train(TRAIN_STEPS)
    else:
        cfg, params, routes = model_setup(args.model)
        frames = np.random.default_rng(SEED).random((args.frames, *SHAPE),
                                                    dtype=np.float32)
        for route in args.routes or routes:
            out[route] = profile_route(cfg, params, frames, route, routes[route])
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
