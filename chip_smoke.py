#!/usr/bin/env python3
"""Drive the PyTorch port's flagship serving path on one NVIDIA H100.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line ({"phase": ...}):

1. device  - needs a CUDA device of compute capability 9.0; prints the card's
             name and power limit as nvidia-smi gives them;
2. build   - compiles csrc/*.cu with nvcc for sm_90a (ops/_build.py);
3. kernels - holds each kernel against its plain PyTorch version at the
             shapes the main path gives it (the 256-frame chunk; the ragged
             tail is padded to it), in float32 with TF32 off and in
             bfloat16, and times both with CUDA events;
4. slice   - Predictor(Config(), use_fused=True) at full width (filters 64,
             192x192x4 frames -> 18 maps, bf16) on seeded random weights made
             by the weight bridge: three requests (256, 256, 100 frames) and
             one predict_movie call, with the kernels' launch counters
             zeroed just before and read just after; then the same frames
             through the "module" route (cuDNN), timed; then the first
             request's maps and peaks, fused vs module, in bf16 (as served,
             and equal to the main path's answer) and in float32 (TF32 off);
5. lift    - lift_to_3d on peaks projected from known 3D points through
             four synthetic DLT cameras.

Then a {"kernels": [...]} line, and last {"ok": true, "device": {...}}. Any
failed check raises, and the script exits nonzero without the ok line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
CHUNK = 256  # Predictor chunk: the batch of every kernel call on the main path
REQUESTS = (256, 256, 100)  # slice-phase request sizes (ragged tail)
F32_ATOL = 1e-4  # kernel vs plain, float32: sums in another order only
BF16_RTOL = 1e-2  # kernel vs plain, bf16: of max|plain|; x1/x2 rounding flips
ROUTE_F32_ATOL = 1e-4  # fused vs module maps, float32, TF32 off
ROUTE_RTOL = 5e-2  # fused vs module maps, bf16: of max|module maps|
CLEAR_MIN = 0.9  # float32: least share of channels whose argmax is pinned
LIFT_RTOL = 1e-3  # 3D error, of the points' spread


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (CUDA events,
    after one warm-up run)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_timed(torch, kernel, plain, reps: int) -> tuple[float, float]:
    """(kernel_ms, plain_ms), timed in turns: plain, kernel, kernel, plain."""
    p1 = time_ms(torch, plain, reps)
    k1 = time_ms(torch, kernel, reps)
    k2 = time_ms(torch, kernel, reps)
    p2 = time_ms(torch, plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_device(torch) -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"needs a Hopper card (capability 9.0), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "capability": list(cap), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name, smi


def phase_build() -> None:
    from pose_estimation_amitai_torch.ops import _build

    t0 = time.perf_counter()
    out_dir = _build.build()
    seconds = time.perf_counter() - t0
    regs = {}
    for log in sorted(out_dir.glob("lib*.log")):
        regs[log.stem[3:]] = [
            line.split(":", 1)[1].strip() for line in log.read_text().splitlines()
            if "registers" in line
        ]
    emit({"phase": "build", "seconds": seconds,
          "dir": str(out_dir.relative_to(_build.BUILD_ROOT.parents[1])),
          "ptxas": regs})


def phase_kernels(torch, params) -> list[dict]:
    """Each kernel vs its plain version at the main path's shapes."""
    from pose_estimation_amitai_torch.models.fast_infer import kernel_params
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    frames = torch.rand((CHUNK, 192, 192, 4), generator=gen, device="cuda")
    cases = {"fused_encoder_stage": [], "fused_decoder": []}
    for dt in (torch.float32, torch.bfloat16):
        kp = kernel_params(params, dt, "cuda")
        x = frames.to(dt)
        for k, st in enumerate(kp["stages"]):
            args = (x, st["w1"], st["b1"], st["w2"], st["b2"], st["w3"], st["b3"])
            kw = dict(dilation=2, alpha=0.1, pool=k < 2)
            got = hc.fused_encoder_stage(*args, **kw)
            want = hc.fused_encoder_stage_plain(*args, **kw)
            cases["fused_encoder_stage"].append(_case(
                torch, f"{tuple(x.shape)}->{tuple(want.shape)}", dt, got, want,
                lambda: hc.fused_encoder_stage(*args, **kw),
                lambda: hc.fused_encoder_stage_plain(*args, **kw),
            ))
            x = want  # the next stage's input: this stage's plain output
        d = kp["decoder"]
        got = hd.fused_decoder(x, **d)
        want = hd.fused_decoder_plain(x, **d)
        cases["fused_decoder"].append(_case(
            torch, f"{tuple(x.shape)}->{tuple(want.shape)}", dt, got, want,
            lambda: hd.fused_decoder(x, **d), lambda: hd.fused_decoder_plain(x, **d),
        ))
    rows = []
    for name, source, replaces in (
        ("fused_encoder_stage", "pose_estimation_amitai_torch/csrc/encoder_stage.cu",
         "pose_estimation_amitai_tpu/ops/pallas_conv.py:245"),
        ("fused_decoder", "pose_estimation_amitai_torch/csrc/decoder.cu",
         "pose_estimation_amitai_tpu/ops/pallas_deconv.py:190"),
    ):
        cs = cases[name]
        bf = [c for c in cs if c["dtype"] == "bfloat16"]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0,  # set from the slice phase's main-path run
            "max_abs_err": max(c["max_abs_err"] for c in cs if c["dtype"] == "float32"),
            "max_abs_err_bf16": max(c["max_abs_err"] for c in bf),
            # bf16 (the served dtype), summed over one chunk's calls
            "ms": sum(c["ms"] for c in bf),
            "plain_ms": sum(c["plain_ms"] for c in bf),
            "tolerance": {"float32_atol": F32_ATOL, "bf16_rtol_of_max": BF16_RTOL},
            "cases": cs,
        })
    emit({"phase": "kernels", "batch": CHUNK, "tf32": False,
          "cases": {r["name"]: r["cases"] for r in rows}})
    return rows


def _case(torch, shape, dt, got, want, kernel_fn, plain_fn) -> dict:
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{shape}: kernel gave {tuple(got.shape)} {got.dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{shape}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if dt == torch.float32:
        check(err <= F32_ATOL, f"{shape} float32: max err {err} > {F32_ATOL}")
    else:
        check(err <= BF16_RTOL * scale,
              f"{shape} bf16: max err {err} > {BF16_RTOL} * {scale}")
    k_ms, p_ms = compare_timed(torch, kernel_fn, plain_fn, reps=5)
    return {"shape": shape, "dtype": str(dt).removeprefix("torch."),
            "max_abs_err": err, "max_abs_plain": scale, "ms": k_ms, "plain_ms": p_ms}


def phase_slice(torch, cfg, params, device_name: str, smi: str) -> dict:
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd

    rng = np.random.default_rng(SEED)
    n = sum(REQUESTS)
    frames = rng.random((n, 192, 192, 4), dtype=np.float32)
    k = 18

    def predictor(c, use_fused: bool, **kw):
        return Predictor(c, params, (192, 192, 4), k, device="cuda",
                         chunk_size=CHUNK, use_fused=use_fused, **kw)

    check(cfg.num_base_filters == 64 and cfg.compute_dtype == "bfloat16",
          "Config() default is filters 64, bf16")
    fused = predictor(cfg, True)
    check(fused.serving_path == "fused", f"serving_path {fused.serving_path}")
    fused(frames[:1])  # warm-up: allocator, library load

    # ---- the main path: counters zeroed just before, read just after ----
    hc.fused_encoder_stage.launches = 0
    hd.fused_decoder.launches = 0
    t0 = time.perf_counter()
    answers, i = [], 0
    for r in REQUESTS:
        answers.append(fused(frames[i : i + r]))
        i += r
    t_req = time.perf_counter() - t0
    t0 = time.perf_counter()
    movie = fused.predict_movie(frames)
    t_movie = time.perf_counter() - t0
    launches = {"fused_encoder_stage": hc.fused_encoder_stage.launches,
                "fused_decoder": hd.fused_decoder.launches}
    # ---------------------------------------------------------------------
    chunks = sum(-(-r // CHUNK) for r in REQUESTS) + -(-n // CHUNK)
    check(launches["fused_encoder_stage"] == 3 * chunks
          and launches["fused_decoder"] == chunks,
          f"launch counts {launches}, expected {3 * chunks} and {chunks}")
    peaks = np.concatenate(answers)
    check(peaks.shape == (n, 3, k) and movie.shape == (n, 3, k),
          f"peak shapes {peaks.shape} {movie.shape}")
    check(bool(np.isfinite(peaks).all()), "non-finite peaks")
    check(bool(((peaks[:, 0] >= 0) & (peaks[:, 0] <= 191)
                & (peaks[:, 1] >= 0) & (peaks[:, 1] <= 191)).all()),
          "peaks outside the frame")
    check(np.array_equal(peaks, movie), "predict_movie disagrees with the requests")

    module = predictor(cfg, False)
    check(module.serving_path == "module", module.serving_path)
    module(frames[:1])
    t0 = time.perf_counter()
    j = 0
    for r in REQUESTS:
        module(frames[j : j + r])
        j += r
    t_mod = time.perf_counter() - t0

    # the first request's maps and peaks, fused vs module, at the served
    # chunk: bf16 as served (the fused peaks are the main path's answer),
    # then float32 with TF32 off, where the routes differ by summation order
    routes = {}
    for dt, c in (("bfloat16", cfg), ("float32", cfg.replace(compute_dtype="float32"))):
        fm, fp = predictor(c, True, return_heatmaps=True)(frames[:CHUNK])
        mm, mp = predictor(c, False, return_heatmaps=True)(frames[:CHUNK])
        if dt == "bfloat16":
            check(np.array_equal(fp, answers[0]),
                  "fused peaks with maps differ from the main path's answer")
            tol = ROUTE_RTOL * float(np.abs(mm).max())
        else:
            tol = ROUTE_F32_ATOL
        routes[dt] = compare_routes(torch, (fm, fp), (mm, mp), tol, dt)
        del fm, mm
    check(routes["float32"]["clear_share"] >= CLEAR_MIN,
          f"float32: argmax pinned in {routes['float32']['clear_share']} of "
          f"channels, under {CLEAR_MIN}")
    result = {
        "phase": "slice", "device": device_name, "nvidia_smi": smi,
        "model": "BasicNet MODEL_18_POINTS_PER_WING filters 64 bf16, 192x192x4 -> 18",
        "requests": list(REQUESTS), "chunk_size": CHUNK,
        "launches": launches,
        "fused_frames_per_s": n / t_req, "fused_movie_frames_per_s": n / t_movie,
        "module_frames_per_s": n / t_mod,
        "routes": routes,
    }
    emit(result)
    return result


def compare_routes(torch, fused_out, module_out, tol: float, dt: str) -> dict:
    """Fused vs module (maps, peaks) of one chunk: maps within ``tol``
    everywhere; argmax peaks equal wherever the module map's top-two gap
    exceeds 2 * tol, where no error within ``tol`` can move the argmax;
    peak values within ``tol``."""
    (fm, fp), (mm, mp) = fused_out, module_out
    check(fm.shape == mm.shape and bool(np.isfinite(fm).all()),
          f"{dt}: fused maps {fm.shape}, module maps {mm.shape}")
    err = float(np.abs(fm - mm).max())
    check(err <= tol, f"{dt}: fused vs module maps differ by {err} > {tol}")
    flat = torch.from_numpy(mm).to("cuda").flatten(1, 2)  # (B, H*W, K)
    top2 = flat.topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 2 * tol).cpu().numpy()  # (B, K)
    same = (fp[:, :2] == mp[:, :2]).all(axis=1)
    check(bool(same[clear].all()),
          f"{dt}: argmax peaks differ where the top-two gap exceeds {2 * tol}")
    val_err = float(np.abs(fp[:, 2] - mp[:, 2]).max())
    check(val_err <= tol, f"{dt}: peak values differ by {val_err} > {tol}")
    return {"frames": fm.shape[0], "max_abs_err": err, "tol": tol,
            "max_abs_maps": float(np.abs(mm).max()),
            "clear_share": float(clear.mean()), "peaks_same_all": float(same.mean()),
            "peak_val_max_abs_err": val_err}


def phase_lift(torch) -> None:
    from pose_estimation_amitai_torch.constants import SENSOR_HEIGHT
    from pose_estimation_amitai_torch.infer import lift_to_3d

    rng = np.random.default_rng(SEED + 1)
    n_frames, n_pts = 4, 18
    pts3d = rng.uniform(-0.004, 0.004, (n_frames, n_pts, 3))
    cams = []
    for yaw, pitch in ((0.0, 0.3), (1.6, -0.2), (3.1, 0.25), (4.7, -0.3)):
        cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
        rot = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]]) @ np.array(
            [[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        center = rot.T @ np.array([0.0, 0.0, -0.25])  # 25 cm from the origin
        kmat = np.array([[3000.0, 0, 640], [0, 3000.0, 400], [0, 0, 1]])
        cams.append(kmat @ np.hstack([rot, -(rot @ center)[:, None]]))
    cams = np.stack(cams)  # (4, 3, 4)
    hom = np.concatenate([pts3d, np.ones((n_frames, n_pts, 1))], -1)
    uvw = np.einsum("cij,fnj->fcni", cams, hom)
    uv = uvw[..., :2] / uvw[..., 2:3]  # (F, 4, N, 2) full-sensor [x, y]
    crop = np.stack([  # [y_crop, x_crop]: a 192 crop around each view's points
        (SENSOR_HEIGHT + 1) - uv[..., 1].mean(-1) - 96, uv[..., 0].mean(-1) - 96,
    ], -1).round()
    local = np.stack([uv[..., 0] - crop[..., 1:2],
                      (SENSOR_HEIGHT + 1) - uv[..., 1] - crop[..., 0:1]], -1)
    check(bool(((local >= 0) & (local < 192)).all()), "synthetic peaks outside crops")
    got = lift_to_3d(local, crop, cams, device="cuda")
    spread = float(np.ptp(pts3d))
    err = float(np.abs(got - pts3d).max())
    check(got.shape == (n_frames, n_pts, 3), f"lift shape {got.shape}")
    check(err <= LIFT_RTOL * spread, f"3D error {err} > {LIFT_RTOL} * {spread}")
    emit({"phase": "lift", "frames": n_frames, "points": n_pts,
          "max_abs_err": err, "spread": spread, "rtol": LIFT_RTOL})


def main() -> int:
    import torch

    from pose_estimation_amitai_torch import Config, weights

    name, smi = phase_device(torch)
    torch.backends.cudnn.allow_tf32 = False  # cuDNN f32 convs default to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    cfg = Config()
    params = weights.init_basicnet_params(
        np.random.default_rng(SEED), in_channels=4, out_channels=18,
        filters=cfg.num_base_filters,
    )
    rows = phase_kernels(torch, params)
    sl = phase_slice(torch, cfg, params, name, smi)
    phase_lift(torch)
    for r in rows:
        r["launches"] = sl["launches"][r["name"]]
        check(r["launches"] > 0, f"{r['name']} never launched on the main path")
    emit({"kernels": [{k: v for k, v in r.items() if k != "cases"} for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
