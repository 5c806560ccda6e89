#!/usr/bin/env python3
"""Drive the PyTorch port's flagship serving paths on one NVIDIA H100.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line ({"phase": ...}):

1. device  - needs a CUDA device of compute capability 9.0; prints the card's
             name and power limit as nvidia-smi gives them;
2. build   - compiles csrc/*.cu with nvcc for sm_90a (ops/_build.py);
3. kernels - holds each kernel against its plain PyTorch version at the
             shapes the main path gives it (the 256-frame chunk; the ragged
             tail is padded to it), in float32 with TF32 off and in
             bfloat16, and times both with CUDA events; the int8 stage at
             its three flagship shapes and the single int8 conv at 192x192x64
             (batch 8 and 256) must equal their plain versions, every element;
4. slice   - Predictor(Config(), use_fused=True) at full width (filters 64,
             192x192x4 frames -> 18 maps, bf16) on seeded random weights made
             by the weight bridge: three requests (256, 256, 100 frames) and
             one predict_movie call, with the kernels' launch counters
             zeroed just before and read just after; then the same frames
             through the "module" route (cuDNN), timed; then the first
             request's maps and peaks, fused vs module, in bf16 (as served,
             and equal to the main path's answer) and in float32 (TF32 off);
5. int8    - Predictor(use_quantized=True, use_fused=True), calibrated on
             the first 128 frames: the same requests and movie with the int8
             stage kernel's counter zeroed and read around them; then the
             "int8_resident" route, timed; then on one 256-frame chunk the
             fused maps against make_quantized_forward's (same scales) and
             both int8 routes against the bf16 module route's maps;
6. im2col  - the single int8 conv on the seeded inputs of
             scripts/exp_im2col_pallas.py: exactness, then microseconds per
             frame and effective TOP/s of the kernel and of its plain version;
7. lift    - lift_to_3d on peaks projected from known 3D points through
             four synthetic DLT cameras.

Then a {"kernels": [...]} line: for each kernel its launches on its path,
its error and times from this run, and ``bound_ms``, the least time the card
could take for the same call: the larger of its operations over the
published peak of their type and its bytes (each operand read once, the
output written once) over the published memory rate. ``library_ms`` is null
throughout: no single PyTorch call computes any of the four functions. Last
{"ok": true, "device": {...}}. Any failed check raises, and the script exits
nonzero without the ok line.
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
CALIB_FRAMES = 128  # int8 calibration set: 4 batches of 32
# int8_fused vs make_quantized_forward maps, same scales: the tolerance of
# tests/test_pallas_qconv.py (a couple of int8 quanta of rounding order)
INT8_FUSED_RTOL = 5e-2  # of max|maps|
INT8_FUSED_CORR = 0.999
# an int8 route vs the bf16 module route's maps, of max|module maps|: the
# quantisation noise of 13 int8 layers on seeded random weights, set at
# about twice what an H100 run of this script showed (0.070 and 0.088)
INT8_VS_BF16_RTOL = 0.18
# published dense peaks of the H100 SXM, for bound_ms
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: float, kind: str, moved: int) -> tuple[float, str]:
    """(bound_ms, bound_by): the least milliseconds the card could take for
    ``ops`` operations of type ``kind`` and ``moved`` bytes."""
    t_ops, t_bytes = ops / PEAK_OPS[kind], moved / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def stage_ops(b: int, h: int, w: int, cin: int, cout: int) -> float:
    """Multiply-adds x 2 of one encoder stage's three 3x3 convs."""
    return 2.0 * 9 * b * h * w * (cin * cout + 2 * cout * cout)


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
    from pose_estimation_amitai_torch.models import quantized
    from pose_estimation_amitai_torch.models.fast_infer import kernel_params
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd
    from pose_estimation_amitai_torch.ops import hopper_qconv as hq
    from pose_estimation_amitai_torch.ops.int8_conv import max_pool_2x2

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    frames = torch.rand((CHUNK, 192, 192, 4), generator=gen, device="cuda")
    cases = {"fused_encoder_stage": [], "fused_decoder": [],
             "fused_quantized_stage": [], "quantized_conv3x3": []}
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
                bound(stage_ops(*x.shape, st["w1"].shape[-1]), "bf16",
                      nbytes(*args, want)),
            ))
            x = want  # the next stage's input: this stage's plain output
        d = kp["decoder"]
        got = hd.fused_decoder(x, **d)
        want = hd.fused_decoder_plain(x, **d)
        pix = x.shape[0] * x.shape[1] * x.shape[2]
        mid, k = d["w1"].shape[-1], d["w4"].shape[-1]
        # real multiply-adds: a stride-2 transposed conv does 9 per input pixel
        ops = 2.0 * 9 * pix * (x.shape[3] * mid + 2 * 4 * mid * mid + 4 * mid * k)
        cases["fused_decoder"].append(_case(
            torch, f"{tuple(x.shape)}->{tuple(want.shape)}", dt, got, want,
            lambda: hd.fused_decoder(x, **d), lambda: hd.fused_decoder_plain(x, **d),
            bound(ops, "bf16", nbytes(x, *d.values(), want)),
        ))
        del got, want

    # the int8 stage at its three flagship shapes: scales calibrated on the
    # first frames, each stage fed the pooled plain output of the one before
    scales = quantized.calibrate(params, frames[:CALIB_FRAMES].cpu().numpy(),
                                 device="cuda")
    layers, s_x = quantized.device_layers(params, scales, "cuda")
    inv = {n: 1.0 / v for n, v in s_x.items()}
    x = hq.quant_bf16(frames, inv["conv1"]).contiguous()
    for s in range(3):
        args = (x, *quantized.stage_args(layers, s))
        nxt = f"conv{3 * s + 4}" if s < 2 else "deconv1"
        kw = dict(inv_s2=inv[f"conv{3 * s + 2}"], inv_s3=inv[f"conv{3 * s + 3}"],
                  inv_out=inv[nxt], dilation=2, alpha=0.1, pool=s < 2)
        got = hq.fused_quantized_stage(*args, **kw)
        want = hq.fused_quantized_stage_plain(*args, **kw)
        cases["fused_quantized_stage"].append(_case_int8(
            torch, f"{tuple(x.shape)}->{tuple(want.shape)}", got, want,
            lambda: hq.fused_quantized_stage(*args, **kw),
            lambda: hq.fused_quantized_stage_plain(*args, **kw),
            bound(stage_ops(*x.shape, want.shape[-1]), "int8", nbytes(*args, want)),
        ))
        x = max_pool_2x2(want).contiguous() if s < 2 else want
        del got, want

    # the single int8 conv on the experiment's seeded inputs, batch 8 and 256
    for b in (IM2COL_BATCH, CHUNK):
        x, w, mult, bias = im2col_inputs(torch, b)
        got = hq.quantized_conv3x3(x, w, mult, bias)
        want = hq.quantized_conv3x3_plain(x, w, mult, bias)
        cases["quantized_conv3x3"].append(_case_int8(
            torch, f"{tuple(x.shape)}->{tuple(want.shape)}", got, want,
            lambda: hq.quantized_conv3x3(x, w, mult, bias),
            lambda: hq.quantized_conv3x3_plain(x, w, mult, bias),
            bound(2.0 * 9 * x.numel() * w.shape[-1], "int8",
                  nbytes(x, w, mult, bias, want)),
        ))
        del got, want

    csrc = "pose_estimation_amitai_torch/csrc/"
    tpu = "pose_estimation_amitai_tpu/ops/"
    rows = []
    for name, source, replaces in (
        ("fused_encoder_stage", csrc + "encoder_stage.cu", tpu + "pallas_conv.py:245"),
        ("fused_decoder", csrc + "decoder.cu", tpu + "pallas_deconv.py:190"),
        ("fused_quantized_stage", csrc + "qconv_stage.cu", tpu + "pallas_qconv.py:227"),
        ("quantized_conv3x3", csrc + "qconv_stage.cu", "scripts/exp_im2col_pallas.py:100"),
    ):
        cs = cases[name]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": 0}  # set from the run of the path that drives it
        if name == "quantized_conv3x3":
            served = cs[-1:]  # batch 256; batch 8 is in the cases
            row.update(max_abs_err=max(c["max_abs_err"] for c in cs),
                       tolerance="int8 outputs equal")
        elif name == "fused_quantized_stage":
            served = cs
            row.update(max_abs_err=max(c["max_abs_err"] for c in cs),
                       tolerance="int8 outputs equal")
        else:
            served = [c for c in cs if c["dtype"] == "bfloat16"]  # the served dtype
            row.update(
                max_abs_err=max(c["max_abs_err"] for c in cs if c["dtype"] == "float32"),
                max_abs_err_bf16=max(c["max_abs_err"] for c in served),
                tolerance={"float32_atol": F32_ATOL, "bf16_rtol_of_max": BF16_RTOL})
        # summed over one chunk's calls
        row.update(ms=sum(c["ms"] for c in served),
                   plain_ms=sum(c["plain_ms"] for c in served),
                   bound_ms=sum(c["bound_ms"] for c in served),
                   bound_by=max(served, key=lambda c: c["bound_ms"])["bound_by"],
                   library_ms=None,  # no single PyTorch call computes it
                   cases=cs)
        rows.append(row)
    emit({"phase": "kernels", "batch": CHUNK, "tf32": False,
          "cases": {r["name"]: r["cases"] for r in rows}})
    return rows


IM2COL_BATCH = 8  # the experiment's batch


def im2col_inputs(torch, batch: int):
    """x, w, mult, bias of scripts/exp_im2col_pallas.py's main (192 x 192 x
    64 -> 64, its value ranges, seed 0), on the card."""
    rng = np.random.default_rng(0)
    w = rng.integers(-90, 90, (3, 3, 64, 64)).astype(np.int8)
    mult = rng.uniform(5e-4, 2e-3, (64,)).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, (64,)).astype(np.float32)
    x = rng.integers(-80, 80, (batch, 192, 192, 64)).astype(np.int8)
    return tuple(torch.from_numpy(a).to("cuda") for a in (x, w, mult, bias))


def _case_int8(torch, shape, got, want, kernel_fn, plain_fn, bnd) -> dict:
    """An int8 kernel must equal its plain version, every element."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype == torch.int8,
          f"{shape}: kernel gave {tuple(got.shape)} {got.dtype}")
    differ = int((got != want).sum())
    err = (got.int() - want.int()).abs().max().item()
    check(differ == 0, f"{shape} int8: {differ} outputs differ, by up to {err}")
    mean = want.float().abs().mean().item()
    check(mean > 4, f"{shape} int8: plain outputs average {mean}: range unused")
    k_ms, p_ms = compare_timed(torch, kernel_fn, plain_fn, reps=3)
    return {"shape": shape, "dtype": "int8", "max_abs_err": err,
            "mean_abs_plain": mean, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1]}


def _case(torch, shape, dt, got, want, kernel_fn, plain_fn, bnd) -> dict:
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
            "max_abs_err": err, "max_abs_plain": scale, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1]}


def serve(pred, frames) -> tuple[list, np.ndarray, float, float]:
    """The requests one by one, then the whole as a movie: (answers, movie
    peaks, seconds of the requests, seconds of the movie)."""
    t0 = time.perf_counter()
    answers, i = [], 0
    for r in REQUESTS:
        answers.append(pred(frames[i : i + r]))
        i += r
    t_req = time.perf_counter() - t0
    t0 = time.perf_counter()
    movie = pred.predict_movie(frames)
    return answers, movie, t_req, time.perf_counter() - t0


def check_peaks(answers, movie, n: int, k: int) -> np.ndarray:
    peaks = np.concatenate(answers)
    check(peaks.shape == (n, 3, k) and movie.shape == (n, 3, k),
          f"peak shapes {peaks.shape} {movie.shape}")
    check(bool(np.isfinite(peaks).all()), "non-finite peaks")
    check(bool(((peaks[:, 0] >= 0) & (peaks[:, 0] <= 191)
                & (peaks[:, 1] >= 0) & (peaks[:, 1] <= 191)).all()),
          "peaks outside the frame")
    check(np.array_equal(peaks, movie), "predict_movie disagrees with the requests")
    return peaks


def phase_slice(torch, cfg, params, frames, device_name: str, smi: str) -> dict:
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd

    n = sum(REQUESTS)
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
    answers, movie, t_req, t_movie = serve(fused, frames)
    launches = {"fused_encoder_stage": hc.fused_encoder_stage.launches,
                "fused_decoder": hd.fused_decoder.launches}
    # ---------------------------------------------------------------------
    chunks = sum(-(-r // CHUNK) for r in REQUESTS) + -(-n // CHUNK)
    check(launches["fused_encoder_stage"] == 3 * chunks
          and launches["fused_decoder"] == chunks,
          f"launch counts {launches}, expected {3 * chunks} and {chunks}")
    check_peaks(answers, movie, n, k)

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


def phase_int8(torch, cfg, params, frames, device_name: str, smi: str) -> dict:
    """The int8 routes through Predictor at full width."""
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.models import quantized
    from pose_estimation_amitai_torch.ops import hopper_qconv as hq

    n = sum(REQUESTS)
    k = 18
    calib = frames[:CALIB_FRAMES]

    def predictor(use_fused: bool, **kw):
        return Predictor(cfg, params, (192, 192, 4), k, device="cuda",
                         chunk_size=CHUNK, use_quantized=True, use_fused=use_fused,
                         calibration_frames=calib, **kw)

    fused = predictor(True)
    check(fused.serving_path == "int8_fused", f"serving_path {fused.serving_path}")
    fused(frames[:1])  # warm-up

    # ---- the int8 path: counter zeroed just before, read just after ----
    hq.fused_quantized_stage.launches = 0
    answers, movie, t_req, t_movie = serve(fused, frames)
    launches = hq.fused_quantized_stage.launches
    # ---------------------------------------------------------------------
    chunks = sum(-(-r // CHUNK) for r in REQUESTS) + -(-n // CHUNK)
    check(launches == 3 * chunks,
          f"fused_quantized_stage launched {launches} times, expected {3 * chunks}")
    check_peaks(answers, movie, n, k)

    resident = predictor(False)
    check(resident.serving_path == "int8_resident", resident.serving_path)
    resident(frames[:1])
    res_answers, res_movie, t_res, _ = serve(resident, frames)
    check_peaks(res_answers, res_movie, n, k)
    check(hq.fused_quantized_stage.launches == launches,
          "the resident route launched the stage kernel")

    # one chunk's maps: fused vs the bf16-activation int8 forward, then both
    # int8 routes vs the bf16 module route, from the predictors that served
    one = frames[:CHUNK]
    fused.return_heatmaps = resident.return_heatmaps = True
    fm, fp = fused(one)
    rm, rp = resident(one)
    check(np.array_equal(fp, answers[0]),
          "int8_fused peaks with maps differ from the int8 path's answer")
    check(np.array_equal(rp, res_answers[0]),
          "int8_resident peaks with maps differ from its served answer")
    scales = quantized.calibrate(params, calib, device="cuda")
    with torch.inference_mode():
        ref = quantized.make_quantized_forward(params, scales, device="cuda")(
            torch.from_numpy(one).to("cuda")).cpu().numpy()
    check(fm.shape == ref.shape and bool(np.isfinite(fm).all()),
          f"int8_fused maps {fm.shape}, reference {ref.shape}")
    top = float(np.abs(ref).max())
    err = float(np.abs(fm - ref).max())
    corr = float(np.corrcoef(fm.ravel()[::7], ref.ravel()[::7])[0, 1])
    check(err < INT8_FUSED_RTOL * top,
          f"int8_fused vs make_quantized_forward: {err} >= {INT8_FUSED_RTOL} * {top}")
    check(corr > INT8_FUSED_CORR, f"int8_fused vs make_quantized_forward: corr {corr}")
    del ref
    mm, mp = Predictor(cfg, params, (192, 192, 4), k, device="cuda", chunk_size=CHUNK,
                       return_heatmaps=True)(one)
    mtop = float(np.abs(mm).max())
    vs_bf16 = {}
    for name, maps, pts in (("int8_fused", fm, fp), ("int8_resident", rm, rp)):
        e = float(np.abs(maps - mm).max())
        check(e <= INT8_VS_BF16_RTOL * mtop,
              f"{name} vs module maps: {e} > {INT8_VS_BF16_RTOL} * {mtop}")
        dist = np.hypot(pts[:, 0] - mp[:, 0], pts[:, 1] - mp[:, 1])
        vs_bf16[name] = {
            "max_abs_err": e, "rel_of_max": e / mtop,
            "mean_abs_err": float(np.abs(maps - mm).mean()),
            "peaks_same_share": float((dist == 0).mean()),
            "peaks_within_2px_share": float((dist <= 2).mean())}
    result = {
        "phase": "int8", "device": device_name, "nvidia_smi": smi,
        "model": "BasicNet MODEL_18_POINTS_PER_WING filters 64 int8, 192x192x4 -> 18",
        "requests": list(REQUESTS), "chunk_size": CHUNK,
        "calibration_frames": CALIB_FRAMES,
        "launches": {"fused_quantized_stage": launches},
        "int8_fused_frames_per_s": n / t_req,
        "int8_fused_movie_frames_per_s": n / t_movie,
        "int8_resident_frames_per_s": n / t_res,
        "fused_vs_quantized_forward": {
            "max_abs_err": err, "max_abs_maps": top, "rtol": INT8_FUSED_RTOL,
            "corr": corr, "corr_min": INT8_FUSED_CORR},
        "vs_bf16_module": {"max_abs_maps": mtop, "rtol": INT8_VS_BF16_RTOL, **vs_bf16},
    }
    emit(result)
    return result


def phase_im2col(torch, device_name: str, smi: str) -> dict:
    """Counterpart of scripts/exp_im2col_pallas.py's main: exactness first,
    then microseconds per frame and effective TOP/s, kernel and plain."""
    from pose_estimation_amitai_torch.ops import hopper_qconv as hq

    x, w, mult, bias = im2col_inputs(torch, IM2COL_BATCH)
    hq.quantized_conv3x3.launches = 0
    got = hq.quantized_conv3x3(x, w, mult, bias)
    torch.cuda.synchronize()
    k_ms = time_ms(torch, lambda: hq.quantized_conv3x3(x, w, mult, bias), reps=50)
    launches = hq.quantized_conv3x3.launches
    ref = hq.quantized_conv3x3_plain(x, w, mult, bias)
    maxdiff = int((got.int() - ref.int()).abs().max())
    check(bool(torch.equal(got, ref)), f"im2col conv differs from plain by {maxdiff}")
    p_ms = time_ms(torch, lambda: hq.quantized_conv3x3_plain(x, w, mult, bias), reps=5)
    ops = 2 * 192 * 192 * 9 * 64 * 64  # per frame
    result = {"phase": "im2col", "device": device_name, "nvidia_smi": smi,
              "exact": True, "maxdiff": maxdiff, "batch": IM2COL_BATCH,
              "launches": launches}
    for name, ms in (("kernel", k_ms), ("plain", p_ms)):
        us = ms * 1e3 / IM2COL_BATCH
        result[name] = {"us_per_frame": us, "eff_TOPs": ops / (us * 1e-6) / 1e12}
    emit(result)
    return result


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
    frames = np.random.default_rng(SEED).random(
        (sum(REQUESTS), 192, 192, 4), dtype=np.float32)
    rows = phase_kernels(torch, params)
    sl = phase_slice(torch, cfg, params, frames, name, smi)
    q8 = phase_int8(torch, cfg, params, frames, name, smi)
    im = phase_im2col(torch, name, smi)
    phase_lift(torch)
    launches = {**sl["launches"], **q8["launches"],
                "quantized_conv3x3": im["launches"]}
    for r in rows:
        r["launches"] = launches[r["name"]]
        check(r["launches"] > 0, f"{r['name']} never launched on its path")
    emit({"kernels": [{k: v for k, v in r.items() if k != "cases"} for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
