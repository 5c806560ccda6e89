#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths on one NVIDIA H100.

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
             the attention kernel on the views the ViT gives it (batch 256 x
             8 heads x 144 tokens x 256, and the 4-camera fusion block's 4
             heads), timed beside ``scaled_dot_product_attention`` on the
             same tensors (a yardstick; nothing in the port calls it); where a
             wrapper chooses between two hand-written kernels (the bf16
             tensor-core ones and the f32 CUDA-core ones), the served shapes
             must take the tensor-core kernel in bfloat16 and the CUDA-core
             kernel in float32 (the int8 ones: the int8 tensor-core kernel,
             the 4-channel first conv its packed-tap form), and general
             shapes per kernel (a stage at 9 -> 70 channels, attention at
             (5, 100, 72), the decoder at ragged sizes on either stride-2
             kernel, the int8 stage at ragged tiles on each of its kernels)
             are held against the plain versions too; the int8 weight
             packing equals its plain version;
4. slice   - Predictor(Config(), use_fused=True) at full width (filters 64,
             192x192x4 frames -> 18 maps, bf16) on seeded random weights made
             by the weight bridge: three requests (256, 256, 100 frames) and
             one predict_movie call, with the kernels' launch counters
             zeroed just before and read just after (every conv of the path,
             the 4-channel first one and the decoder's two, must have taken a
             tensor-core kernel); then the same frames
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
             four synthetic DLT cameras;
8. vit     - Predictor(Config(model_type=MODEL_18_POINTS_PER_WING_VIT)) at
             full width (patch 16, dim 256, depth 8, heads 8, dim_head 256,
             MLP 1024, bf16) on seeded weights: the same requests and movie
             on the "fused" route (every attention core on the attention
             kernel, its counter zeroed just before and read just after: 8
             launches a chunk), then on the "module" route with the bf16
             softmax chain (the default) and with the exact softmax; then
             fused vs module on one chunk in float32 and in bf16;
9. vit4cam - ALL_CAMS_18_POINTS_VIT (192x192x16 -> 72 maps), full width, 64
             frames folded (chunk 64) and unfolded (chunk 128), fused vs
             module, the attention launches counted (12 and 48);
10. probes - the probe kernels as the two experiment scripts' mains run
             them, and the bisect script's other cases, each equal to its
             plain version.

Then a {"kernels": [...]} line: for each kernel its launches on its path,
its error and times from this run, and ``bound_ms``, the least time the card
could take for the same call: the larger of its operations over the
published peak of their type and its bytes (each operand read once, the
output written once) over the published memory rate. ``library_ms`` is the time of the one PyTorch call
that computes the same function, where there is one (the attention kernel:
``scaled_dot_product_attention``), else null. The rows of the kernels that
were redesigned for the tensor cores (all five that compute) also carry
``previous_ms``, the time in this run of the CUDA-core kernel they replace,
on the same tensors, and ``kernel``, which of the wrapper's kernels the
served shape took. Last
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
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
VIT_F32_ATOL = 1e-4  # fused vs module normalised maps, float32, TF32 off
VIT4_FRAMES = 64  # one chunk of the 4-camera model each way
VIT4_FOLD_RTOL = 2e-2  # folded vs unfolded bf16 maps, of their range
PEAK_BYTES = 3.35e12
PREVIOUS_REPS = 2  # timed runs of a CUDA-core kernel on a served shape


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


def compare_timed(torch, kernel, plain, reps: int, library=None):
    """(kernel_ms, plain_ms, library_ms or None), timed in turns: [library,]
    plain, kernel, kernel, plain[, library]."""
    l1 = time_ms(torch, library, reps) if library else None
    p1 = time_ms(torch, plain, reps)
    k1 = time_ms(torch, kernel, reps)
    k2 = time_ms(torch, kernel, reps)
    p2 = time_ms(torch, plain, reps)
    l_ms = (l1 + time_ms(torch, library, reps)) / 2 if library else None
    return (k1 + k2) / 2, (p1 + p2) / 2, l_ms


def took(counter: dict, fn):
    """(fn(), the kernels it ran by a wrapper's by-kernel counter, each name
    as often as it ran, joined by +)."""
    before = dict(counter)
    out = fn()
    names = [k for k in counter for _ in range(counter[k] - before[k])]
    return out, "+".join(names)


def decoder_kernels(convs: str, up2: str) -> str:
    """The decoder's four launches in order, from the names its two by-kernel
    counters gave (``took``: each sorted by name, so a mixed pair reads
    "fma+mma" whichever layer took which)."""
    return f"up2({up2})+conv({convs})"


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
    from pose_estimation_amitai_torch.ops import hopper_attention as ha
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd
    from pose_estimation_amitai_torch.ops import hopper_qconv as hq
    from pose_estimation_amitai_torch.ops.int8_conv import max_pool_2x2

    # the shared-memory figures of the dispatch rules are the libraries' own
    for dil in (1, 2, hc.MAX_DILATION):
        for packed in (False, True):
            check(hc.conv_mma_smem_bytes(dil, packed)
                  == hc.conv_mma_smem_bytes_built(dil, packed),
                  f"conv shared memory at dilation {dil}, packed {packed}")
    check(ha.attention_mma_smem_bytes(VIT_TOKENS, VIT_DIM_HEAD)
          == ha.attention_mma_smem_bytes_built(VIT_TOKENS, VIT_DIM_HEAD),
          "attention shared memory at the served shape")
    check(hd.up2_mma_smem_bytes() == hd.up2_mma_smem_bytes_built(),
          "stride-2 layer shared memory")
    for dil in (1, 2, hc.MAX_DILATION):
        check(hq.qconv_mma_smem_bytes(dil) == hq.qconv_mma_smem_bytes_built(dil),
              f"int8 conv shared memory at dilation {dil}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    frames = torch.rand((CHUNK, 192, 192, 4), generator=gen, device="cuda")
    cases = {"fused_encoder_stage": [], "fused_decoder": [],
             "fused_quantized_stage": [], "quantized_conv3x3": [],
             "fused_attention": []}
    for dt in (torch.float32, torch.bfloat16):
        kp = kernel_params(params, dt, "cuda")
        x = frames.to(dt)
        for k, st in enumerate(kp["stages"]):
            args = (x, st["w1"], st["b1"], st["w2"], st["b2"], st["w3"], st["b3"])
            kw = dict(dilation=2, alpha=0.1, pool=k < 2)
            got, ran = took(hc.fused_encoder_stage.convs_by_kernel,
                            lambda: hc.fused_encoder_stage(*args, **kw))
            want = hc.fused_encoder_stage_plain(*args, **kw)
            expect = "fma+fma+fma" if dt == torch.float32 else (
                "mma+mma+mma_c4" if k == 0 else "mma+mma+mma")
            check(ran == expect, f"stage {k} {dt}: kernels {ran}, expected {expect}")
            cases["fused_encoder_stage"].append(_case(
                torch, f"{tuple(x.shape)}->{tuple(want.shape)}", dt, got, want,
                lambda: hc.fused_encoder_stage(*args, **kw),
                lambda: hc.fused_encoder_stage_plain(*args, **kw),
                bound(stage_ops(*x.shape, st["w1"].shape[-1]), "bf16",
                      nbytes(*args, want)),
            ))
            cases["fused_encoder_stage"][-1]["kernel"] = ran
            if dt == torch.bfloat16:
                cases["fused_encoder_stage"][-1].update(
                    previous_ms=time_ms(torch, lambda: hc.fused_encoder_stage_on(
                        ("fma",) * 3, *args, **kw), PREVIOUS_REPS),
                    **rounding_flips(torch, got, want, args, kw))
            x = want  # the next stage's input: this stage's plain output
        d = kp["decoder"]
        (got, ran), up2 = took(hd.fused_decoder.up2_by_kernel, lambda: took(
            hd.fused_decoder.convs_by_kernel, lambda: hd.fused_decoder(x, **d)))
        want = hd.fused_decoder_plain(x, **d)
        expect = "fma+fma" if dt == torch.float32 else "mma+mma"
        check(ran == expect and up2 == expect,
              f"decoder {dt}: stride-1 convs on {ran}, stride-2 layers on {up2}")
        pix = x.shape[0] * x.shape[1] * x.shape[2]
        mid, k = d["w1"].shape[-1], d["w4"].shape[-1]
        # real multiply-adds: a stride-2 transposed conv does 9 per input pixel
        ops = 2.0 * 9 * pix * (x.shape[3] * mid + 2 * 4 * mid * mid + 4 * mid * k)
        cases["fused_decoder"].append(_case(
            torch, f"{tuple(x.shape)}->{tuple(want.shape)}", dt, got, want,
            lambda: hd.fused_decoder(x, **d), lambda: hd.fused_decoder_plain(x, **d),
            bound(ops, "bf16", nbytes(x, *d.values(), want)),
        ))
        cases["fused_decoder"][-1]["kernel"] = decoder_kernels(ran, up2)
        if dt == torch.bfloat16:
            # the kernel before: the stride-2 layers on the CUDA cores, the
            # stride-1 convs on the tensor cores as they have been
            cases["fused_decoder"][-1]["previous_ms"] = time_ms(
                torch, lambda: hd.fused_decoder_on("mma", ("fma", "fma"), x, **d),
                PREVIOUS_REPS)
        del got, want

    # a general shape on the CUDA-core conv kernel in bf16 (channel counts off
    # the tensor-core tiles), held against plain like the served ones
    x = torch.rand((2, 40, 52, 9), generator=gen, device="cuda").to(torch.bfloat16)
    args = [x]
    for c in (9, 70, 70):
        args += [(torch.randn((3, 3, c, 70), generator=gen, device="cuda")
                  * (9 * c) ** -0.5).to(torch.bfloat16),
                 torch.randn((70,), generator=gen, device="cuda") * 0.05]
    got, ran = took(hc.fused_encoder_stage.convs_by_kernel,
                    lambda: hc.fused_encoder_stage(*args, dilation=2, pool=True))
    want = hc.fused_encoder_stage_plain(*args, dilation=2, pool=True)
    check(ran == "fma+fma+fma", f"9 -> 70 channels took {ran}")
    general = {"fused_encoder_stage": [_case(
        torch, f"{tuple(x.shape)}->{tuple(want.shape)}", torch.bfloat16, got, want,
        lambda: hc.fused_encoder_stage(*args, dilation=2, pool=True),
        lambda: hc.fused_encoder_stage_plain(*args, dilation=2, pool=True),
        bound(stage_ops(*x.shape, 70), "bf16", nbytes(*args, want)))]}
    general["fused_encoder_stage"][0]["kernel"] = "fma+fma+fma"
    del got, want

    # the decoder in bf16 at ragged sizes: both stride-2 layers on the
    # tensor-core kernel (Cin a multiple of 16; K = 5 off every multiple the
    # stores like), a whole-row head of 24 channels beside a CUDA-core layer,
    # and both layers on the CUDA-core kernel (cin 9)
    general["fused_decoder"] = []
    for cin, mid, k, expect in ((48, 32, 5, "mma+mma"), (48, 24, 5, "fma+mma"),
                                (9, 24, 5, "fma+fma")):
        x = torch.rand((2, 13, 10, cin), generator=gen, device="cuda").to(torch.bfloat16)
        args = [x]
        for ci, co in ((cin, mid), (mid, mid), (mid, mid), (mid, k)):
            args += [(torch.randn((3, 3, ci, co), generator=gen, device="cuda")
                      * (9 * ci) ** -0.5).to(torch.bfloat16),
                     torch.randn((co,), generator=gen, device="cuda") * 0.05]
        (got, ran), up2 = took(hd.fused_decoder.up2_by_kernel, lambda: took(
            hd.fused_decoder.convs_by_kernel, lambda: hd.fused_decoder(*args)))
        want = hd.fused_decoder_plain(*args)
        check(up2 == expect, f"decoder {cin} -> {mid} -> {k}: stride-2 layers on {up2}")
        pix = x.shape[0] * x.shape[1] * x.shape[2]
        general["fused_decoder"].append(_case(
            torch, f"{tuple(x.shape)}->{mid}->{tuple(want.shape)}", torch.bfloat16,
            got, want, lambda: hd.fused_decoder(*args),
            lambda: hd.fused_decoder_plain(*args),
            bound(2.0 * 9 * pix * (cin * mid + 8 * mid * mid + 4 * mid * k), "bf16",
                  nbytes(*args, want))))
        general["fused_decoder"][-1]["kernel"] = decoder_kernels(ran, up2)
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
        got, ran = took(hq.fused_quantized_stage.convs_by_kernel,
                        lambda: hq.fused_quantized_stage(*args, **kw))
        want = hq.fused_quantized_stage_plain(*args, **kw)
        expect = "mma_s8+mma_s8+mma_s8_c4" if s == 0 else "mma_s8+mma_s8+mma_s8"
        check(ran == expect, f"int8 stage {s}: kernels {ran}, expected {expect}")
        for n in (f"conv{3 * s + i}" for i in (1, 2, 3)):  # packed once, by the kernel
            check(bool(torch.equal(layers[n]["w_packed"],
                                   hq.pack_qconv_weights_plain(layers[n]["w_q"]))),
                  f"{n}: packed weights differ from the plain packing")
        # the operands as the JAX function takes them (HWIO int8 weights)
        operands = [x] + [t for n in (f"conv{3 * s + i}" for i in (1, 2, 3))
                          for t in (layers[n]["w_q"], layers[n]["mult"], layers[n]["bias"])]
        cases["fused_quantized_stage"].append(_case_int8(
            torch, f"{tuple(x.shape)}->{tuple(want.shape)}", got, want,
            lambda: hq.fused_quantized_stage(*args, **kw),
            lambda: hq.fused_quantized_stage_plain(*args, **kw),
            bound(stage_ops(*x.shape, want.shape[-1]), "int8", nbytes(*operands, want)),
        ))
        cases["fused_quantized_stage"][-1].update(
            kernel=ran, previous_ms=time_ms(
                torch, lambda: hq.fused_quantized_stage_on(("dp4a",) * 3, *args, **kw),
                PREVIOUS_REPS))
        x = max_pool_2x2(want).contiguous() if s < 2 else want
        del got, want

    # the int8 stage at ragged tiles (40 x 52 pixels, the last channel tile
    # half full), dilation 1 and 3, on the tensor-core kernel; at 32 -> 40
    # channels, where only the first conv takes it; at 4 -> 40 (the first
    # conv on the 4-channel tensor-core kernel); at 9 -> 70 on the CUDA-core
    # kernel
    general["fused_quantized_stage"] = []
    rng = np.random.default_rng(SEED)
    for cin, cout, dil, expect in ((32, 96, 1, "mma_s8+mma_s8+mma_s8"),
                                   (32, 96, 3, "mma_s8+mma_s8+mma_s8"),
                                   (32, 40, 3, "dp4a+dp4a+mma_s8"),
                                   (4, 40, 3, "dp4a+dp4a+mma_s8_c4"),
                                   (9, 70, 2, "dp4a+dp4a+dp4a")):
        args = [torch.from_numpy(rng.integers(-127, 128, (2, 40, 52, cin)).astype(np.int8))]
        for c in (cin, cout, cout):
            args += [torch.from_numpy(a) for a in (
                rng.integers(-127, 128, (3, 3, c, cout)).astype(np.int8),
                (rng.uniform(0.5, 1.5, cout) / (np.sqrt(9 * c) * 5329)).astype(np.float32),
                (rng.standard_normal(cout) * 0.05).astype(np.float32))]
        args = [a.to("cuda") for a in args]
        kw = dict(inv_s2=30.0, inv_s3=25.0, inv_out=35.0, dilation=dil, pool=dil != 1)
        got, ran = took(hq.fused_quantized_stage.convs_by_kernel,
                        lambda: hq.fused_quantized_stage(*args, **kw))
        want = hq.fused_quantized_stage_plain(*args, **kw)
        check(ran == expect, f"int8 stage {cin} -> {cout}: kernels {ran}, expected {expect}")
        general["fused_quantized_stage"].append(_case_int8(
            torch, f"(2, 40, 52, {cin})->{cout} dilation {dil}", got, want,
            lambda: hq.fused_quantized_stage(*args, **kw),
            lambda: hq.fused_quantized_stage_plain(*args, **kw),
            bound(stage_ops(2, 40, 52, cin, cout), "int8", nbytes(*args, want))))
        general["fused_quantized_stage"][-1]["kernel"] = ran
        del got, want

    # the single int8 conv on the experiment's seeded inputs, batch 8 and 256
    for b in (IM2COL_BATCH, CHUNK):
        x, w, mult, bias = im2col_inputs(torch, b)
        got, ran = took(hq.quantized_conv3x3.launches_by_kernel,
                        lambda: hq.quantized_conv3x3(x, w, mult, bias))
        want = hq.quantized_conv3x3_plain(x, w, mult, bias)
        check(ran == "mma_s8", f"the single int8 conv took {ran}")
        cases["quantized_conv3x3"].append(_case_int8(
            torch, f"{tuple(x.shape)}->{tuple(want.shape)}", got, want,
            lambda: hq.quantized_conv3x3(x, w, mult, bias),
            lambda: hq.quantized_conv3x3_plain(x, w, mult, bias),
            bound(2.0 * 9 * x.numel() * w.shape[-1], "int8",
                  nbytes(x, w, mult, bias, want)),
        ))
        cases["quantized_conv3x3"][-1].update(
            kernel=ran, previous_ms=time_ms(
                torch, lambda: hq.quantized_conv3x3_on("dp4a", x, w, mult, bias),
                PREVIOUS_REPS))
        del got, want

    # the attention kernel on the ViT's own views: q, k, v sliced from one
    # (B, N, 3, H, D) tensor, the result written through a permuted view;
    # the encoder's 8 heads in float32 and bf16, the fusion block's 4 in bf16
    import torch.nn.functional as F

    for dt, heads in ((torch.float32, 8), (torch.bfloat16, 8), (torch.bfloat16, 4)):
        qkv = torch.randn((CHUNK, VIT_TOKENS, 3, heads, VIT_DIM_HEAD), generator=gen,
                          device="cuda").to(dt)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # (B, H, N, D)
        out = torch.empty((CHUNK, VIT_TOKENS, heads, VIT_DIM_HEAD), dtype=dt,
                          device="cuda")
        got, ran = took(ha.fused_attention.launches_by_kernel,
                        lambda: ha.fused_attention(q, k, v, out=out.permute(0, 2, 1, 3)))
        want = ha.fused_attention_plain(q, k, v)
        check(ran == ("fma" if dt == torch.float32 else "mma"),
              f"attention {dt} heads {heads}: kernel {ran}")
        g = CHUNK * heads
        cases["fused_attention"].append(_case(
            torch, f"{tuple(q.shape)} heads {heads}", dt, got, want,
            lambda: ha.fused_attention(q, k, v, out=out.permute(0, 2, 1, 3)),
            lambda: ha.fused_attention_plain(q, k, v),
            bound(4.0 * g * VIT_TOKENS ** 2 * VIT_DIM_HEAD,
                  "f32" if dt == torch.float32 else "bf16", nbytes(q, k, v, want)),
            library_fn=lambda: F.scaled_dot_product_attention(q, k, v),
        ))
        lib = F.scaled_dot_product_attention(q, k, v)
        cases["fused_attention"][-1]["library_max_abs_err"] = (
            lib.float() - want.float()).abs().max().item()
        cases["fused_attention"][-1]["kernel"] = ran
        if dt == torch.bfloat16:
            cases["fused_attention"][-1]["previous_ms"] = time_ms(
                torch, lambda: ha.fused_attention_on(
                    "fma", q, k, v, out=out.permute(0, 2, 1, 3)), 5)
        del qkv, out, got, want, lib

    # a general shape on the CUDA-core attention kernel in bf16 (N off the
    # 16-row tiles, D off the multiples of 16)
    q, k, v = (torch.randn((5, 100, 72), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    got, ran = took(ha.fused_attention.launches_by_kernel,
                    lambda: ha.fused_attention(q, k, v))
    want = ha.fused_attention_plain(q, k, v)
    check(ran == "fma", f"attention (5, 100, 72) took {ran}")
    general["fused_attention"] = [_case(
        torch, "(5, 100, 72)", torch.bfloat16, got, want,
        lambda: ha.fused_attention(q, k, v),
        lambda: ha.fused_attention_plain(q, k, v),
        bound(4.0 * 5 * 100 ** 2 * 72, "bf16", nbytes(q, k, v, want)),
        library_fn=lambda: F.scaled_dot_product_attention(q, k, v))]
    general["fused_attention"][0]["kernel"] = "fma"
    del got, want

    csrc = "pose_estimation_amitai_torch/csrc/"
    tpu = "pose_estimation_amitai_tpu/ops/"
    rows = []
    for name, source, replaces in (
        ("fused_encoder_stage", csrc + "encoder_stage.cu", tpu + "pallas_conv.py:245"),
        ("fused_decoder", csrc + "decoder.cu", tpu + "pallas_deconv.py:190"),
        ("fused_quantized_stage", csrc + "qconv_stage.cu", tpu + "pallas_qconv.py:227"),
        ("quantized_conv3x3", csrc + "qconv_stage.cu", "scripts/exp_im2col_pallas.py:100"),
        ("fused_attention", csrc + "attention.cu", "scripts/exp_fused_attention.py:63"),
    ):
        cs = cases[name]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": 0}  # set from the run of the path that drives it
        library_ms = None  # no single PyTorch call computes it
        if name == "fused_attention":
            served = cs[1:2]  # one launch of the encoder's, bf16, as served
            library_ms = served[0]["library_ms"]
            row.update(
                max_abs_err=cs[0]["max_abs_err"],
                max_abs_err_bf16=max(c["max_abs_err"] for c in cs[1:]),
                tolerance={"float32_atol": F32_ATOL, "bf16_rtol_of_max": BF16_RTOL})
        elif name == "quantized_conv3x3":
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
                   library_ms=library_ms, cases=cs)
        if "previous_ms" in served[0]:
            row.update(previous_ms=sum(c["previous_ms"] for c in served),
                       kernel=[c["kernel"] for c in served])
        if name in general:
            row["general_cases"] = general[name]
        rows.append(row)
    emit({"phase": "kernels", "batch": CHUNK, "tf32": False,
          "cases": {r["name"]: r["cases"] for r in rows}, "general_cases": general})
    return rows


IM2COL_BATCH = 8  # the experiment's batch
VIT_TOKENS = 144  # (192 / 16) ** 2
VIT_DIM_HEAD = 256  # Config(): dim_head = projection_dim


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
    k_ms, p_ms, _ = compare_timed(torch, kernel_fn, plain_fn, reps=3)
    return {"shape": shape, "dtype": "int8", "max_abs_err": err,
            "mean_abs_plain": mean, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1]}


def _case(torch, shape, dt, got, want, kernel_fn, plain_fn, bnd, library_fn=None) -> dict:
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
    k_ms, p_ms, l_ms = compare_timed(torch, kernel_fn, plain_fn, 5, library_fn)
    return {"shape": shape, "dtype": str(dt).removeprefix("torch."),
            "max_abs_err": err, "max_abs_plain": scale, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": l_ms}


def rounding_flips(torch, got, want, args, kw) -> dict:
    """Where a bf16 stage's distance from its plain version comes from.
    The kernel takes each conv's f32 sum in another order than the plain
    version, so an x1 or x2 that lies near a rounding boundary lands one bf16
    step to the other side and the next conv carries the step on. Shown by
    the plain version itself with every conv's sum taken in two halves of
    the input channels, which no kernel touches: its distance from the plain
    version beside the kernel's, each as the largest error, the share of
    outputs that differ at all and the share beyond half the limit."""
    import torch.nn.functional as F

    from pose_estimation_amitai_torch.ops.hopper_conv import bias_nchw, lrelu

    half_limit = 0.5 * BF16_RTOL * want.float().abs().max().item()

    def distance(a, b):
        d = (a.float() - b.float()).abs()
        return {"max_abs_err": d.max().item(),
                "share_differing": (d > 0).float().mean().item(),
                "share_over_half_the_limit": (d > half_limit).float().mean().item()}

    x, w1, b1, w2, b2, w3, b3 = args
    dil, alpha, dt = kw["dilation"], kw["alpha"], x.dtype

    def conv(h, w):
        wt, half = w.float().permute(3, 2, 0, 1), h.shape[1] // 2
        return (F.conv2d(h[:, :half], wt[:, :half], padding=dil, dilation=dil)
                + F.conv2d(h[:, half:], wt[:, half:], padding=dil, dilation=dil))

    h = x.permute(0, 3, 1, 2).float()
    x1 = lrelu(conv(h, w1) + bias_nchw(b1), alpha).to(dt).float()
    x2 = (lrelu(conv(x1, w2) + bias_nchw(b2), alpha) + x1).to(dt).float()
    y = lrelu(conv(x2, w3) + bias_nchw(b3), alpha) + x2
    del h, x1
    if kw["pool"]:
        y = lrelu(F.max_pool2d(y, 2, 2, ceil_mode=True), alpha)
    halves = y.to(dt).permute(0, 2, 3, 1)
    return {"kernel_vs_plain": distance(got, want),
            "plain_in_halves_vs_plain": distance(halves, want)}


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
    hc.fused_encoder_stage.convs_by_kernel = dict.fromkeys(hc.CONV_KERNEL_CODES, 0)
    hd.fused_decoder.convs_by_kernel = dict.fromkeys(hd.fused_decoder.convs_by_kernel, 0)
    hd.fused_decoder.up2_by_kernel = dict.fromkeys(hd.UP2_KERNEL_CODES, 0)
    answers, movie, t_req, t_movie = serve(fused, frames)
    launches = {"fused_encoder_stage": hc.fused_encoder_stage.launches,
                "fused_decoder": hd.fused_decoder.launches}
    convs = dict(hc.fused_encoder_stage.convs_by_kernel)
    decoder_convs = dict(hd.fused_decoder.convs_by_kernel)
    decoder_up2 = dict(hd.fused_decoder.up2_by_kernel)
    # ---------------------------------------------------------------------
    chunks = sum(-(-r // CHUNK) for r in REQUESTS) + -(-n // CHUNK)
    check(convs == {"fma": 0, "mma": 8 * chunks, "mma_c4": chunks}
          and decoder_convs == {"fma": 0, "mma": 2 * chunks}
          and decoder_up2 == {"fma": 0, "mma": 2 * chunks},
          f"the served convs took {convs}, the decoder's {decoder_convs}, its "
          f"stride-2 layers {decoder_up2}: not all on the tensor cores")
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
        "launches": launches, "encoder_convs_by_kernel": convs,
        "decoder_convs_by_kernel": decoder_convs,
        "decoder_up2_by_kernel": decoder_up2,
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
    hq.fused_quantized_stage.convs_by_kernel = dict.fromkeys(hq.QCONV_KERNEL_CODES, 0)
    packs = hq.pack_qconv_weights.launches
    answers, movie, t_req, t_movie = serve(fused, frames)
    launches = hq.fused_quantized_stage.launches
    convs = dict(hq.fused_quantized_stage.convs_by_kernel)
    # ---------------------------------------------------------------------
    chunks = sum(-(-r // CHUNK) for r in REQUESTS) + -(-n // CHUNK)
    check(launches == 3 * chunks,
          f"fused_quantized_stage launched {launches} times, expected {3 * chunks}")
    check(convs == {"dp4a": 0, "mma_s8": 8 * chunks, "mma_s8_c4": chunks},
          f"the served int8 convs took {convs}: all belong on the tensor cores, "
          "the 4-channel first conv on its own kernel")
    check(hq.pack_qconv_weights.launches == packs,
          "serving packed weights again: they are packed once, with the predictor")
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
        "int8_convs_by_kernel": convs,
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


def vit_params(cfg, in_channels: int, out_channels: int, four: bool) -> dict:
    """Seeded flax-layout params of the ViT ``cfg`` builds, at its widths."""
    from pose_estimation_amitai_torch import weights

    return weights.init_vit_params(
        np.random.default_rng(SEED), in_channels, out_channels, 192,
        patch_size=cfg.patch_size, dim=cfg.projection_dim,
        depth=cfg.transformer_layers, heads=cfg.num_heads,
        dim_head=cfg.projection_dim if cfg.dim_head else 64,
        mlp_expand=cfg.fully_connected_expand, kernel_size=cfg.kernel_size,
        four_cameras=four)


def phase_vit(torch, frames, device_name: str, smi: str) -> dict:
    """ViT serving through Predictor at full width: the fused route (the
    attention kernel) and the module route."""
    from pose_estimation_amitai_torch import Config
    from pose_estimation_amitai_torch import constants as C
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.ops import hopper_attention as ha

    n = sum(REQUESTS)
    k = 18
    cfg = Config(model_type=C.MODEL_18_POINTS_PER_WING_VIT)
    check((cfg.projection_dim, cfg.transformer_layers, cfg.num_heads, cfg.patch_size,
           cfg.fully_connected_expand, bool(cfg.dim_head), cfg.compute_dtype)
          == (256, 8, 8, 16, 4, True, "bfloat16"), "Config() ViT defaults changed")
    params = vit_params(cfg, 4, k, four=False)

    def predictor(c, **kw):
        return Predictor(c, params, (192, 192, 4), k, device="cuda", chunk_size=CHUNK, **kw)

    fused = predictor(cfg, use_fused=True)
    check(fused.serving_path == "fused" and fused.model.fused_attention
          and not fused.model.fast_softmax, f"serving_path {fused.serving_path}")
    fused(frames[:1])  # warm-up: allocator, library load

    # ---- the ViT path: counter zeroed just before, read just after ----
    ha.fused_attention.launches = 0
    ha.fused_attention.launches_by_kernel = dict.fromkeys(ha.KERNEL_CODES, 0)
    answers, movie, t_req, t_movie = serve(fused, frames)
    launches = ha.fused_attention.launches
    by_kernel = dict(ha.fused_attention.launches_by_kernel)
    # --------------------------------------------------------------------
    chunks = sum(-(-r // CHUNK) for r in REQUESTS) + -(-n // CHUNK)
    depth = cfg.transformer_layers
    check(by_kernel == {"fma": 0, "mma": launches},
          f"the served attention launches took {by_kernel}")
    check(launches == depth * chunks,
          f"fused_attention launched {launches} times, expected {depth * chunks}")
    check_peaks(answers, movie, n, k)

    rates = {}
    for name, kw in (("module", {}), ("module_exact_softmax", {"fast_softmax": False})):
        pred = predictor(cfg, **kw)
        check(pred.serving_path == "module"
              and pred.model.fast_softmax is (name == "module"), name)
        pred(frames[:1])
        ans, mov, t, _ = serve(pred, frames)
        check_peaks(ans, mov, n, k)
        rates[name + "_frames_per_s"] = n / t
    check(ha.fused_attention.launches == launches,
          "the module route launched the attention kernel")

    # one chunk's normalised maps and peaks, fused vs module (exact softmax
    # on both: maps are returned): float32 with TF32 off, where the routes
    # differ by summation order, then bf16 as served
    routes = {}
    for dt, c in (("float32", cfg.replace(compute_dtype="float32")), ("bfloat16", cfg)):
        fm, fp = predictor(c, use_fused=True, return_heatmaps=True)(frames[:CHUNK])
        mm, mp = predictor(c, return_heatmaps=True)(frames[:CHUNK])
        if dt == "bfloat16":
            # peaks-only serving decoded the raw maps and rescaled the vals
            check(np.array_equal(fp, answers[0]),
                  "fused peaks with maps differ from the ViT path's answer")
            tol = ROUTE_RTOL * float(np.abs(mm).max())
        else:
            tol = VIT_F32_ATOL
        routes[dt] = compare_routes(torch, (fm, fp), (mm, mp), tol, dt)
        del fm, mm
    result = {
        "phase": "vit", "device": device_name, "nvidia_smi": smi,
        "model": "ViTPoseNet MODEL_18_POINTS_PER_WING_VIT patch 16 dim 256 depth 8 "
                 "heads 8 dim_head 256 mlp 1024 bf16, 192x192x4 -> 18",
        "requests": list(REQUESTS), "chunk_size": CHUNK,
        "launches": {"fused_attention": launches},
        "attention_launches_by_kernel": by_kernel,
        "fused_frames_per_s": n / t_req, "fused_movie_frames_per_s": n / t_movie,
        **rates, "routes": routes,
    }
    emit(result)
    return result


def phase_vit4cam(torch, device_name: str, smi: str) -> None:
    """The 4-camera ViT at full width: one chunk of 64 frames with the views
    folded into the batch (chunk 64) and one by one (chunk 128), fused vs
    module. Frames are 4 views x 4 channels on the channel axis, as the
    preprocessor lays this model type out."""
    from pose_estimation_amitai_torch import Config
    from pose_estimation_amitai_torch import constants as C
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.ops import hopper_attention as ha

    k, shape = 72, (192, 192, 16)
    cfg = Config(model_type=C.ALL_CAMS_18_POINTS_VIT)
    params = vit_params(cfg, shape[-1], k, four=True)
    frames = np.random.default_rng(SEED + 2).random((VIT4_FRAMES, *shape), dtype=np.float32)
    depth, fuse = cfg.transformer_layers, 4
    result = {"phase": "vit4cam", "device": device_name, "nvidia_smi": smi,
              "model": "ViT4Cameras ALL_CAMS_18_POINTS_VIT dim 256 depth 8 heads 8 "
                       "dim_head 256, 4 fusion blocks (dim 1280, heads 4), bf16, "
                       "192x192x16 -> 72", "frames": VIT4_FRAMES}
    fused_maps = {}
    for name, chunk, want in (("folded", VIT4_FRAMES, depth + fuse),
                              ("unfolded", 128, 4 * (depth + fuse))):
        def predictor(**kw):
            return Predictor(cfg, params, shape, k, device="cuda", chunk_size=chunk, **kw)

        fused = predictor(use_fused=True)
        check(fused.serving_path == "fused"
              and fused.model.fold_views is (name == "folded"), name)
        fused(frames[:1])
        ha.fused_attention.launches = 0
        ha.fused_attention.launches_by_kernel = dict.fromkeys(ha.KERNEL_CODES, 0)
        t0 = time.perf_counter()
        pts = fused(frames)
        t_fused = time.perf_counter() - t0
        launches = ha.fused_attention.launches
        check(launches == want, f"{name}: {launches} attention launches, expected {want}")
        check(ha.fused_attention.launches_by_kernel["mma"] == want,
              f"{name}: launches by kernel {ha.fused_attention.launches_by_kernel}")
        check(pts.shape == (VIT4_FRAMES, 3, k) and bool(np.isfinite(pts).all()),
              f"{name}: peaks {pts.shape}")
        module = predictor()
        module(frames[:1])
        t0 = time.perf_counter()
        module(frames)
        t_module = time.perf_counter() - t0
        fm, fp = predictor(use_fused=True, return_heatmaps=True)(frames)
        mm, mp = predictor(return_heatmaps=True)(frames)
        check(np.array_equal(fp, pts), f"{name}: peaks with maps differ from peaks-only")
        cmp = compare_routes(torch, (fm, fp), (mm, mp),
                             ROUTE_RTOL * float(np.abs(mm).max()), f"{name} bfloat16")
        fused_maps[name] = fm
        result[name] = {"chunk_size": chunk, "launches": launches,
                        "fused_frames_per_s": VIT4_FRAMES / t_fused,
                        "module_frames_per_s": VIT4_FRAMES / t_module,
                        "fused_vs_module": cmp}
        del mm
    diff = float(np.abs(fused_maps["folded"] - fused_maps["unfolded"]).max())
    check(diff <= VIT4_FOLD_RTOL, f"folded vs unfolded maps differ by {diff}")
    result["folded_vs_unfolded_max_abs"] = diff
    emit(result)


def phase_probes(torch, device_name: str, smi: str) -> list[dict]:
    """The probe kernels on the two experiment scripts' inputs, each equal to
    its plain version: the bisect script's five cases and its two full-conv
    sizes, and the six probes of the Mosaic script's main. Returns the two
    rows of the kernels line."""
    from pose_estimation_amitai_torch.ops import hopper_probes as hp
    from pose_estimation_amitai_torch.ops import hopper_qconv as hq

    x = hp.run_case_input("cuda")
    full = {g: hp.run_full_inputs(g, "cuda") for g in (1, 4)}
    a = torch.arange(8 * 128, device="cuda").to(torch.int8).reshape(8, 128)
    b = torch.ones((8, 128), dtype=torch.int8, device="cuda")
    ones = {n: torch.ones((n, 8, 128), device="cuda") for n in (8, 16, 32, 64)}
    xi = torch.ones((16, 8, 128), dtype=torch.int8, device="cuda")
    # (name, kernel, plain, the one PyTorch call of the same function or None)
    bisect_specs = [
        ("k_copy", lambda: hp.k_copy(x), lambda: hp.k_copy_plain(x), x.clone),
        ("k_stage", lambda: hp.k_stage(x), lambda: hp.k_stage_plain(x), x.clone),
        ("k_dyn_read", lambda: hp.k_dyn_read(x), lambda: hp.k_dyn_read_plain(x), x.clone),
        ("k_reshape", lambda: hp.k_reshape(x), lambda: hp.k_reshape_plain(x), x.clone),
        ("k_concat_dot", lambda: hp.k_concat_dot(x), lambda: hp.k_concat_dot_plain(x), None),
    ] + [
        (f"full_epilogue_grid{g}", lambda g=g: hp.full_epilogue(*full[g]),
         lambda g=g: hp.full_epilogue_plain(*full[g]), None) for g in full
    ]
    mosaic_specs = [
        ("int8_vector_arith", lambda: hp.int8_vector_arith(a, b),
         lambda: hp.int8_vector_arith_plain(a, b), None),
    ] + [
        (f"grid_{n}", lambda n=n: hp.grid_scale(ones[n]),
         lambda n=n: hp.grid_scale_plain(ones[n]), lambda n=n: torch.mul(ones[n], 2.0))
        for n in ones
    ] + [
        ("int8_int32_grid_16", lambda: hp.int8_vector_in_grid(xi),
         lambda: hp.int8_vector_in_grid_plain(xi), None),
    ]

    # ---- the probes, once each as the scripts run them: counters zeroed
    # just before, read just after ----
    for fn in hp.PROBES:
        fn.launches = 0
    full_before = hq.quantized_conv3x3.launches
    outs = {name: kernel() for name, kernel, _, _ in bisect_specs + mosaic_specs}
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in hp.PROBES}
    launches["full_epilogue"] = hq.quantized_conv3x3.launches - full_before
    # -------------------------------------------------------------------
    check(launches == {"k_copy": 1, "k_stage": 1, "k_dyn_read": 1, "k_reshape": 1,
                       "k_concat_dot": 1, "full_epilogue": 2, "int8_vector_arith": 1,
                       "grid_scale": 4, "int8_vector_in_grid": 1},
          f"probe launch counts {launches}")
    # the scripts' own expectations
    check(bool(torch.equal(outs["int8_vector_arith"], (a.int() * 2 + 1).to(torch.int8))),
          "int8 a * 2 + b did not wrap")
    check(all(bool((outs[f"grid_{n}"] == 2.0).all()) for n in ones), "a grid probe is not 2.0")
    check(bool((outs["int8_int32_grid_16"] == 2).all()), "int8_int32_grid_16 is not 2")

    def compare(name, kernel_fn, plain_fn, library_fn) -> dict:
        got, want = outs[name], plain_fn()
        check(got.shape == want.shape and got.dtype == want.dtype
              and bool(torch.equal(got, want)), f"probe {name} differs from plain")
        conv = "dot" in name or "full" in name
        ops = 2.0 * 9 * want.numel() * want.shape[-1] if conv else 0.0
        reads = 2 if name == "int8_vector_arith" else 1  # inputs of the output's size
        bnd = bound(ops, "int8", (reads + 1) * nbytes(want))
        k_ms, p_ms, l_ms = compare_timed(torch, kernel_fn, plain_fn, 20, library_fn)
        return {"probe": name, "shape": list(want.shape),
                "dtype": str(want.dtype).removeprefix("torch."), "max_abs_err": 0.0,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": l_ms}

    bisect = [compare(*spec) for spec in bisect_specs]
    mosaic = [compare(*spec) for spec in mosaic_specs]
    csrc = "pose_estimation_amitai_torch/csrc/probes.cu"
    rows = []
    for name, cases, replaces, names in (
        ("bisect_probes", bisect, "scripts/exp_im2col_bisect.py:21",
         ("k_copy", "k_stage", "k_dyn_read", "k_reshape", "k_concat_dot", "full_epilogue")),
        ("mosaic_probes", mosaic, "scripts/exp_mosaic_probe.py:37",
         ("int8_vector_arith", "grid_scale", "int8_vector_in_grid")),
    ):
        rows.append({
            "name": name, "route": "cuda", "source": csrc, "replaces": replaces,
            "launches": sum(launches[k] for k in names),
            "max_abs_err": 0.0, "tolerance": "outputs equal",
            # summed over the probes, one launch each
            "ms": sum(c["ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": sum(c["bound_ms"] for c in cases),
            "bound_by": max(cases, key=lambda c: c["bound_ms"])["bound_by"],
            "library_ms": None,  # several functions: no single PyTorch call
        })
    emit({"phase": "probes", "device": device_name, "nvidia_smi": smi,
          "launches": launches, "bisect": bisect, "mosaic": mosaic})
    return rows


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
    vt = phase_vit(torch, frames, name, smi)
    phase_vit4cam(torch, name, smi)
    probe_rows = phase_probes(torch, name, smi)
    launches = {**sl["launches"], **q8["launches"], **vt["launches"],
                "quantized_conv3x3": im["launches"]}
    for r in rows:
        r["launches"] = launches[r["name"]]
    rows += probe_rows
    for r in rows:
        check(r["launches"] > 0, f"{r['name']} never launched on its path")
    emit({"kernels": [{k: v for k, v in r.items() if k != "cases"} for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
