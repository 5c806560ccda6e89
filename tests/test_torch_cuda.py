"""The port's hand-written CUDA kernels vs their plain versions, on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false. This file imports only torch and the port (no jax), so it runs on a
machine without the JAX package, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Shapes here are deliberately ragged (sizes off the kernels' 8 x 16 x 64
tiles, channel counts off the 8-channel staging chunk) to reach every
masked edge; chip_smoke.py covers the flagship shapes. The int8 kernels
round every float step where their plain versions do, so they are held to
equality.
"""

import numpy as np
import pytest
import torch

from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.infer import Predictor
from pose_estimation_amitai_torch.ops import hopper_attention as ha
from pose_estimation_amitai_torch.ops import hopper_conv as hc
from pose_estimation_amitai_torch.ops import hopper_probes as hp
from pose_estimation_amitai_torch.models import quantized
from pose_estimation_amitai_torch.ops import hopper_deconv as hd
from pose_estimation_amitai_torch.ops import hopper_qconv as hq
from pose_estimation_amitai_torch.weights import init_basicnet_params, init_vit_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cudnn.allow_tf32 = False  # the plain versions' convs
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4, err  # summation order only
    else:
        assert err <= 1e-2 * want.float().abs().max().item(), err  # bf16 rounding


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, h, w, cin, cout, dil, pool", [
    (2, 20, 36, 3, 24, 2, True),
    (1, 13, 17, 9, 70, 1, False),
    (3, 24, 24, 16, 130, 3, True),
    (2, 9, 50, 5, 8, 2, False),
])
def test_encoder_stage_kernel_matches_plain(cuda, dtype, b, h, w, cin, cout, dil, pool):
    gen = torch.Generator(device="cuda").manual_seed(cin * cout)
    x = _rand(gen, b, h, w, cin).abs().to(dtype)
    args = [x]
    for c in (cin, cout, cout):
        args += [_rand(gen, 3, 3, c, cout, scale=(9 * c) ** -0.5).to(dtype),
                 _rand(gen, cout, scale=0.05)]
    before = hc.fused_encoder_stage.launches
    got = hc.fused_encoder_stage(*args, dilation=dil, pool=pool)
    assert hc.fused_encoder_stage.launches == before + 1
    _close(got, hc.fused_encoder_stage_plain(*args, dilation=dil, pool=pool), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, r, w, cin, mid, k", [
    (2, 5, 7, 20, 12, 5),
    (1, 12, 12, 256, 128, 18),
    (2, 3, 9, 64, 40, 70),
])
def test_decoder_kernel_matches_plain(cuda, dtype, b, r, w, cin, mid, k):
    gen = torch.Generator(device="cuda").manual_seed(cin + mid + k)
    args = [_rand(gen, b, r, w, cin).abs().to(dtype)]
    for ci, co in ((cin, mid), (mid, mid), (mid, mid), (mid, k)):
        args += [_rand(gen, 3, 3, ci, co, scale=(9 * ci) ** -0.5).to(dtype),
                 _rand(gen, co, scale=0.05)]
    before = hd.fused_decoder.launches
    got = hd.fused_decoder(*args)
    assert hd.fused_decoder.launches == before + 1
    assert got.shape == (b, 4 * r, 4 * w, k)
    _close(got, hd.fused_decoder_plain(*args), dtype)


def test_wrappers_check_operands(cuda):
    x = torch.rand(1, 8, 8, 4, device="cuda")
    w1 = torch.rand(3, 3, 4, 8, device="cuda")
    w = torch.rand(3, 3, 8, 8, device="cuda")
    b = torch.rand(8, device="cuda")
    with pytest.raises(TypeError):  # weight dtype differs from x
        hc.fused_encoder_stage(x, w1.bfloat16(), b, w, b, w, b)
    with pytest.raises(ValueError, match="shape"):
        hc.fused_encoder_stage(x, w, b, w, b, w, b)
    with pytest.raises(ValueError, match="contiguous"):
        hc.fused_encoder_stage(x.transpose(1, 2), w1, b, w, b, w, b)
    with pytest.raises(ValueError, match="even"):
        hc.fused_encoder_stage(x[:, :7].contiguous(), w1, b, w, b, w, b)
    with pytest.raises(TypeError):
        hd.fused_decoder(x.half(), w1.half(), b, w.half(), b, w.half(), b, w.half(), b)


def test_predictor_fused_matches_module_on_card(cuda):
    """f32 on the card: the fused kernels and the cuDNN module route agree
    to summation order (TF32 off)."""
    cfg = Config(num_base_filters=8, compute_dtype="float32")
    params = init_basicnet_params(np.random.default_rng(0), 4, 6, filters=8)
    frames = np.random.default_rng(1).random((5, 48, 48, 4)).astype(np.float32)
    out = [Predictor(cfg, params, (48, 48, 4), 6, device="cuda", chunk_size=2,
                     return_heatmaps=True, use_fused=f)(frames) for f in (False, True)]
    np.testing.assert_allclose(out[1][0], out[0][0], atol=1e-4)
    np.testing.assert_allclose(out[1][1], out[0][1], atol=1e-4)


@pytest.mark.parametrize("dtype, convs", [
    ("bfloat16", {"fma": 0, "mma_c4": 1, "wgmma": 8}),
    ("float32", {"fma": 9, "mma_c4": 0, "wgmma": 0}),
])
def test_flagship_forward_counts_its_convs_by_kernel(cuda, dtype, convs):
    """One chunk of the flagship BasicNet (filters 64, 192 x 192 x 4 -> 18)
    through the fused Predictor: in bf16 the first conv on the packed kernel
    and the 10 other stride-1 convs (8 of the encoder, 2 of the decoder) on
    the wgmma kernel; in float32 all 11 on the CUDA cores."""
    params = init_basicnet_params(np.random.default_rng(0), 4, 18, filters=64)
    pred = Predictor(Config(compute_dtype=dtype), params, (192, 192, 4), 18, device="cuda",
                     chunk_size=2, use_fused=True)
    frames = np.random.default_rng(1).random((2, 192, 192, 4), dtype=np.float32)
    enc = dict(hc.fused_encoder_stage.convs_by_kernel)
    dec = dict(hd.fused_decoder.convs_by_kernel)
    pred(frames)
    torch.cuda.synchronize()
    assert {k: v - enc[k] for k, v in hc.fused_encoder_stage.convs_by_kernel.items()} == convs
    assert {k: v - dec[k] for k, v in hd.fused_decoder.convs_by_kernel.items()} == {
        "fma": 2 * (dtype == "float32"), "wgmma": 2 * (dtype == "bfloat16")}


def _fused_predictor(chunk_size: int, hw: int = 48) -> Predictor:
    params = init_basicnet_params(np.random.default_rng(0), 4, 6, filters=16)
    pred = Predictor(Config(num_base_filters=16), params, (hw, hw, 4), 6, device="cuda",
                     chunk_size=chunk_size, use_fused=True)
    assert pred.serving_path == "fused"
    return pred


def test_staged_copies_are_pinned_and_off_the_compute_stream(cuda):
    """__call__ and predict_movie copy every chunk from the stager's two
    pinned buffers, on its own stream: the profiler sees one pinned H2D copy
    a chunk, none pageable, on no stream the kernels ran on."""
    from torch.autograd import DeviceType

    pred = _fused_predictor(8)
    st = pred._stager
    assert st.stream is not None and st.stream != torch.cuda.current_stream()
    frames = np.random.default_rng(1).random((19, 48, 48, 4), dtype=np.float32)
    want = pred(frames)
    assert len(st._buffers) == 2 and all(b.is_pinned() for b in st._buffers)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = [pred(frames), pred.predict_movie(frames, prefetch=2)]
        torch.cuda.synchronize()
    for g in got:
        np.testing.assert_array_equal(g, want)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in dev if "HtoD" in e.name]
    kernel_streams = {e.device_resource_id for e in dev if "conv3x3" in e.name}
    assert len(copies) == 6 and all("Pinned" in e.name for e in copies), \
        [e.name for e in copies]
    assert kernel_streams and not kernel_streams & {e.device_resource_id for e in copies}


def test_movie_of_distinct_chunks_equals_resident_chunks(cuda):
    """7 chunks of distinct frames and a tail: predict_movie at prefetch 1,
    2 and 4, and __call__, bit for bit each chunk served alone from a
    device-resident tensor, for float32, uint8, read-only and strided numpy
    (numpy's assignment fills those) and CPU-tensor frames. A pinned buffer
    refilled before its copy ran, or a staged tensor reused before the
    compute stream read it, gives another chunk's peaks."""
    cs, hw = 32, 96
    pred = _fused_predictor(cs, hw)
    rng = np.random.default_rng(2)
    base = rng.random((7 * cs + 5, hw, hw, 5), dtype=np.float32)
    read_only = base[..., :4].copy()
    read_only.setflags(write=False)
    movies = {"float32": base[..., :4].copy(), "read_only": read_only,
              "strided": base[..., :4], "uint8": (base[..., :4] * 255).astype(np.uint8),
              "tensor": torch.from_numpy(base[..., :4].copy())}
    for kind, movie in movies.items():
        want = np.concatenate([pred(torch.as_tensor(movie[i : i + cs]).cuda())
                               for i in range(0, len(movie), cs)])
        for prefetch in (1, 2, 4):
            np.testing.assert_array_equal(pred.predict_movie(movie, prefetch=prefetch), want,
                                          err_msg=f"{kind} prefetch {prefetch}")
        np.testing.assert_array_equal(pred(movie), want, err_msg=kind)


@pytest.mark.parametrize("lagging", ["copy", "compute"])
def test_staging_holds_while_a_stream_lags(cuda, lagging):
    """A spin kernel (~50 ms) queued first on the copy stream holds the
    copies back while the host refills the pinned ring: each buffer must
    wait for the copy out of it. Queued first on the compute stream, it
    holds the kernels back while the host stages the next chunks: a staged
    tensor must not be handed out again before the kernels read it. Either
    way the movie's peaks are the resident chunks', bit for bit."""
    cs = 8
    pred = _fused_predictor(cs)
    frames = np.random.default_rng(3).random((6 * cs, 48, 48, 4), dtype=np.float32)
    want = np.concatenate([pred(torch.from_numpy(frames[i : i + cs]).cuda())
                           for i in range(0, len(frames), cs)])
    st = pred._stager
    st.buffers(torch.float32, frames.shape[1:])
    torch.cuda.synchronize()
    stream = st.stream if lagging == "copy" else torch.cuda.current_stream()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(100_000_000)
    np.testing.assert_array_equal(pred.predict_movie(frames, prefetch=4), want)


@pytest.mark.parametrize("failure", ["alloc", "unpinned"])
def test_a_pin_failure_raises(cuda, monkeypatch, failure):
    """No fallback to a pageable copy: a pinned allocation that raises, or
    that comes back unpinned, fails the call."""
    pred = _fused_predictor(4)
    empty = torch.empty

    def fake(*args, **kw):
        if kw.get("pin_memory"):
            if failure == "alloc":
                raise RuntimeError("cudaHostAlloc failed")
            kw["pin_memory"] = False
        return empty(*args, **kw)

    monkeypatch.setattr(torch, "empty", fake)
    frames = np.zeros((5, 48, 48, 4), np.float32)
    with pytest.raises(RuntimeError, match="cudaHostAlloc failed" if failure == "alloc"
                       else "not pinned"):
        pred(frames)


def _int8(rng, *shape, lim=127):
    return torch.from_numpy(rng.integers(-lim, lim + 1, shape).astype(np.int8)).cuda()


def _dequant_args(rng, cin, cout):
    """int8 weights with a multiplier that brings the conv to unit scale."""
    mult = (rng.uniform(0.5, 1.5, cout) / (np.sqrt(9 * cin) * 5329)).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.05).astype(np.float32)
    return [_int8(rng, 3, 3, cin, cout), torch.from_numpy(mult).cuda(),
            torch.from_numpy(bias).cuda()]


@pytest.mark.parametrize("b, h, w, cin, cout, dil, pool", [
    (2, 20, 36, 4, 24, 2, True),     # one dp4a word per pixel
    (1, 13, 17, 5, 7, 1, False),     # channels off the 4-byte word, odd H x W
    (3, 24, 24, 33, 130, 3, True),   # more than one 64-channel tile and chunk
    (2, 9, 50, 64, 64, 8, False),    # the widest halo
])
def test_quantized_stage_kernel_equals_plain(cuda, b, h, w, cin, cout, dil, pool):
    rng = np.random.default_rng(cin * cout + dil)
    args = [_int8(rng, b, h, w, cin)]
    for c in (cin, cout, cout):
        args += _dequant_args(rng, c, cout)
    invs = [float(v) for v in rng.uniform(20, 40, 3)]
    before = hq.fused_quantized_stage.launches
    got = hq.fused_quantized_stage(*args, *invs, dilation=dil, pool=pool)
    torch.cuda.synchronize()
    assert hq.fused_quantized_stage.launches == before + 1
    want = hq.fused_quantized_stage_plain(*args, *invs, dilation=dil, pool=pool)
    assert got.shape == (b, h, w, cout) and got.dtype == torch.int8
    assert 5 < want.float().abs().mean() < 64  # the int8 range is used, unsaturated
    assert torch.equal(got, want)


@pytest.mark.parametrize("b, h, w, cin, cout, dil", [
    (2, 24, 40, 64, 64, 2),
    (1, 17, 19, 5, 7, 1),
    (2, 16, 16, 12, 70, 3),
    (1, 11, 33, 130, 9, 8),
])
def test_quantized_conv3x3_kernel_equals_plain(cuda, b, h, w, cin, cout, dil):
    rng = np.random.default_rng(h + cin)
    mult = (rng.uniform(5e-4, 2e-3, cout) * 64 / cin).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
    args = [_int8(rng, b, h, w, cin, lim=80), _int8(rng, 3, 3, cin, cout, lim=90),
            torch.from_numpy(mult).cuda(), torch.from_numpy(bias).cuda()]
    before = hq.quantized_conv3x3.launches
    got = hq.quantized_conv3x3(*args, dilation=dil)
    torch.cuda.synchronize()
    assert hq.quantized_conv3x3.launches == before + 1
    want = hq.quantized_conv3x3_plain(*args, dilation=dil)
    assert got.shape == (b, h, w, cout) and got.dtype == torch.int8
    assert want.float().abs().mean() > 10
    assert torch.equal(got, want)


def test_qconv_wrappers_check_operands(cuda):
    rng = np.random.default_rng(0)
    x = _int8(rng, 1, 8, 8, 4)
    l1, l2 = _dequant_args(rng, 4, 8), _dequant_args(rng, 8, 8)
    with pytest.raises(TypeError, match="int8"):
        hq.fused_quantized_stage(x.float(), *l1, *l2, *l2, 1.0, 1.0, 1.0)
    with pytest.raises(TypeError):  # float weights
        hq.quantized_conv3x3(x, l1[0].float(), l1[1], l1[2])
    with pytest.raises(ValueError, match="shape"):
        hq.fused_quantized_stage(x, *l2, *l2, *l2, 1.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        hq.quantized_conv3x3(x.transpose(1, 2), *l1)
    with pytest.raises(ValueError, match="dilation"):
        hq.quantized_conv3x3(x, *l1, dilation=9)
    with pytest.raises(ValueError):  # multipliers left on the CPU
        hq.quantized_conv3x3(x, l1[0], l1[1].cpu(), l1[2])


@pytest.mark.parametrize("route", ["fused", "resident", "bf16"])
def test_int8_forward_on_card_equals_cpu(cuda, route):
    """Same scales on both devices: the int8 products are exact, every float
    step rounds on its own, and the stage kernel equals its plain version,
    so the card's maps equal the CPU's."""
    params = init_basicnet_params(np.random.default_rng(0), 4, 6, filters=8)
    frames = np.random.default_rng(1).random((3, 48, 48, 4)).astype(np.float32)
    scales = quantized.calibrate(params, frames, device="cpu")
    make = {"fused": quantized.make_quantized_fused_forward,
            "resident": quantized.make_quantized_resident_forward,
            "bf16": quantized.make_quantized_forward}[route]
    before = hq.fused_quantized_stage.launches
    got = make(params, scales, device="cuda", out_dtype=torch.float32)(
        torch.from_numpy(frames).cuda()).cpu()
    assert hq.fused_quantized_stage.launches == before + (3 if route == "fused" else 0)
    want = make(params, scales, device="cpu", out_dtype=torch.float32)(
        torch.from_numpy(frames))
    assert torch.equal(got, want)


def test_calibrate_repeats_on_card(cuda):
    """Calibration asks for deterministic conv algorithms, so the same
    frames give the same scales every time (also with most of the card's
    memory held, which changes the workspace the library may use), and two
    predictors built alike decode the same peaks."""
    cfg = Config(num_base_filters=16, compute_dtype="float32")
    params = init_basicnet_params(np.random.default_rng(0), 4, 6, filters=16)
    frames = np.random.default_rng(1).random((12, 96, 96, 4)).astype(np.float32)
    first = quantized.calibrate(params, frames, batch=4, device="cuda")
    assert quantized.calibrate(params, frames, batch=4, device="cuda") == first
    free, _ = torch.cuda.mem_get_info()
    held = torch.empty(int(free * 0.8), dtype=torch.uint8, device="cuda")
    again = quantized.calibrate(params, frames, batch=4, device="cuda")
    del held
    assert again == first
    peaks = [Predictor(cfg, params, (96, 96, 4), 6, device="cuda", chunk_size=8,
                       use_quantized=True, use_fused=True,
                       calibration_frames=frames)(frames) for _ in range(2)]
    np.testing.assert_array_equal(peaks[0], peaks[1])


def test_predictor_int8_routes_on_card(cuda):
    """Both int8 routes through Predictor on the card: calibration runs in
    float32 with TF32 off, so the scales track the CPU's to summation order
    and the maps agree within a few int8 quanta (5% of the max)."""
    cfg = Config(num_base_filters=8, compute_dtype="float32")
    params = init_basicnet_params(np.random.default_rng(0), 4, 6, filters=8)
    frames = np.random.default_rng(1).random((5, 48, 48, 4)).astype(np.float32)
    for use_fused, path in ((False, "int8_resident"), (True, "int8_fused")):
        out = {}
        for dev in ("cpu", "cuda"):
            pred = Predictor(cfg, params, (48, 48, 4), 6, device=dev, chunk_size=2,
                             return_heatmaps=True, use_quantized=True,
                             use_fused=use_fused, calibration_frames=frames)
            assert pred.serving_path == path
            out[dev] = pred(frames)[0]
        assert np.abs(out["cuda"] - out["cpu"]).max() <= 5e-2 * np.abs(out["cpu"]).max()


# ---------------------------------------------------------------------------
# attention kernel, probe kernels, ViT serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g, n, d", [
    (2048, 144, 256),  # the served shape: batch 256 x 8 heads
    (13, 144, 64),     # dim head 64; G off any multiple of 8
    (5, 100, 72),      # N off the 48-row tiles, D off the 64-column chunks
    (3, 7, 8),         # smaller than one tile
    (2, 300, 40),      # more keys than the served shape
])
def test_attention_kernel_matches_plain(cuda, dtype, g, n, d):
    gen = torch.Generator(device="cuda").manual_seed(g + n + d)
    q, k, v = (_rand(gen, g, n, d).to(dtype) for _ in range(3))
    before = ha.fused_attention.launches
    got = ha.fused_attention(q, k, v)
    assert ha.fused_attention.launches == before + 1
    assert got.is_contiguous()
    _close(got, ha.fused_attention_plain(q, k, v), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_on_module_views(cuda, dtype):
    """q, k, v sliced from one (B, N, 3, H, D) tensor and the result written
    through a permuted view, as models/vit.py calls it: no copy is made."""
    b, n, h, d = 6, 144, 4, 256
    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv = _rand(gen, b, n, 3, h, d).to(dtype)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    out = torch.full((b, n, h, d), float("nan"), dtype=dtype, device="cuda")
    res = ha.fused_attention(q, k, v, out=out.permute(0, 2, 1, 3))
    assert res.data_ptr() == out.data_ptr()
    _close(out.permute(0, 2, 1, 3), ha.fused_attention_plain(q, k, v), dtype)


def test_attention_wrapper_checks_operands(cuda):
    q = torch.rand(4, 16, 16, device="cuda")
    with pytest.raises(TypeError):
        ha.fused_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="shape"):
        ha.fused_attention(q, q[:, :8], q)
    with pytest.raises(ValueError, match="multiple of 8"):
        ha.fused_attention(q[..., :12], q[..., :12], q[..., :12])
    with pytest.raises(ValueError, match="contiguous"):
        ha.fused_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(ValueError, match="aligned"):  # base 8 bytes off
        off = torch.rand(4 * 16 * 16 + 2, device="cuda")[2:].view(4, 16, 16)
        ha.fused_attention(q, q, off)
    with pytest.raises(ValueError, match="outside"):
        big = torch.rand(1, ha.MAX_N + 1, 8, device="cuda")
        ha.fused_attention(big, big, big)
    with pytest.raises(TypeError):
        ha.fused_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):  # v left on the CPU
        ha.fused_attention(q, q, q.cpu())


@pytest.mark.parametrize("shape", [(1, 192, 192, 64), (2, 37, 50, 12), (3, 16, 32, 4)])
@pytest.mark.parametrize("name", ["k_copy", "k_stage", "k_dyn_read", "k_reshape",
                                  "k_concat_dot"])
def test_bisect_probe_kernel_equals_plain(cuda, name, shape):
    rng = np.random.default_rng(shape[1])
    lim = 80 if name != "k_concat_dot" or shape[-1] == 64 else 4
    x = _int8(rng, *shape, lim=lim)
    fn = getattr(hp, name)
    before = fn.launches
    got = fn(x)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, getattr(hp, name + "_plain")(x))


@pytest.mark.parametrize("grid_b", [1, 4])
def test_full_epilogue_kernel_equals_plain(cuda, grid_b):
    args = hp.run_full_inputs(grid_b, "cuda")
    before = hq.quantized_conv3x3.launches
    got = hp.full_epilogue(*args)
    torch.cuda.synchronize()
    assert hq.quantized_conv3x3.launches == before + 1
    assert torch.equal(got, hp.full_epilogue_plain(*args))
    x, w, m, b = args  # the weights packed once: no pack launch in the call
    packed = hq.pack_qconv_weights(hp._hwio(w))
    packs = hq.pack_qconv_weights.launches
    assert torch.equal(hp.full_epilogue(x, packed, m, b), got)
    assert hq.pack_qconv_weights.launches == packs


def test_mosaic_probe_kernels_equal_plain(cuda):
    a = torch.arange(8 * 128, device="cuda").to(torch.int8).reshape(8, 128)
    b = torch.ones((8, 128), dtype=torch.int8, device="cuda")
    assert torch.equal(hp.int8_vector_arith(a, b), hp.int8_vector_arith_plain(a, b))
    rng = np.random.default_rng(0)
    for n in (8, 16, 32, 64):
        x = torch.from_numpy(rng.standard_normal((n, 8, 128)).astype(np.float32)).cuda()
        assert torch.equal(hp.grid_scale(x), hp.grid_scale_plain(x))
    xi = _int8(rng, 16, 8, 128, lim=127)
    assert torch.equal(hp.int8_vector_in_grid(xi), hp.int8_vector_in_grid_plain(xi))
    assert hp.int8_vector_arith.launches and hp.grid_scale.launches >= 4
    with pytest.raises(TypeError):
        hp.grid_scale(xi)
    with pytest.raises(ValueError, match="at most 64"):
        hp.k_stage(_int8(rng, 1, 8, 8, 65))


def _offset_view(t, offset=1):
    """A contiguous copy of ``t`` that starts ``offset`` bytes past a 16-byte
    boundary."""
    step = t.element_size()
    buf = torch.empty(t.numel() * step + 16 + offset, dtype=torch.int8, device=t.device)
    start = (-buf.data_ptr()) % 16 + offset
    view = buf[start:start + t.numel() * step].view(t.dtype).view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset % 16
    return view


def _probe_kernels(fn, call):
    """(call(), the kernels it launched by ``fn.launches_by_kernel``), with
    ``fn.launches`` checked to count the same launches."""
    before, launches = dict(fn.launches_by_kernel), fn.launches
    out = call()
    torch.cuda.synchronize()
    ran = tuple(k for k in fn.launches_by_kernel
                for _ in range(fn.launches_by_kernel[k] - before[k]))
    assert fn.launches == launches + len(ran)
    return out, ran


@pytest.mark.parametrize("shape", [(1, 192, 192, 64), (2, 37, 50, 48), (3, 16, 32, 16),
                                   (2, 9, 11, 12), "unaligned"])
@pytest.mark.parametrize("name", ["k_stage", "k_dyn_read", "k_reshape", "k_concat_dot"])
def test_staged_probe_on_both_kernels_equals_plain(cuda, name, shape):
    """The rule's kernel and the byte-wise one, each equal to plain; where
    the rule names the byte-wise kernel (C off 16, an unaligned frame) the
    16-byte one is refused."""
    rng = np.random.default_rng(7)
    lim = 2 if name == "k_concat_dot" else 127
    x = _offset_view(_int8(rng, 2, 13, 21, 32, lim=lim)) if shape == "unaligned" \
        else _int8(rng, *shape, lim=lim)
    fn, on = getattr(hp, name), getattr(hp, name + "_on")
    want = getattr(hp, name + "_plain")(x)
    expect = "vec16" if shape not in ("unaligned", (2, 9, 11, 12)) else "byte"
    assert hp.probe_kernel_for(x) == expect
    got, ran = _probe_kernels(fn, lambda: fn(x))
    assert ran == (expect,) and torch.equal(got, want)
    got, ran = _probe_kernels(fn, lambda: on("byte", x))
    assert ran == ("byte",) and torch.equal(got, want)
    if expect == "byte":
        with pytest.raises(ValueError, match="does not take"):
            on("vec16", x)
    if name == "k_concat_dot":  # sums short of the clip
        assert (want.abs() < 127).float().mean().item() > 0.1


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("name", ["k_copy", "int8_vector_arith", "grid_scale",
                                  "int8_vector_in_grid"])
def test_flat_probe_with_a_tail_on_both_kernels_equals_plain(cuda, name, aligned):
    """Sizes off 16 bytes (a scalar tail; slabs that start off a 16-byte
    boundary: a scalar head), the script's probes at their own sizes."""
    rng = np.random.default_rng(3)
    if name == "grid_scale":
        ops = [torch.from_numpy(rng.standard_normal((5, 7, 9)).astype(np.float32)).cuda()]
    elif name == "int8_vector_in_grid":
        ops = [_int8(rng, 6, 5, 13, lim=127)]
    elif name == "int8_vector_arith":
        ops = [_int8(rng, 3, 333, lim=127), _int8(rng, 3, 333, lim=127)]
    else:
        ops = [_int8(rng, 2, 37, 50, 3, lim=127)]
    assert ops[0].numel() * ops[0].element_size() % 16
    if not aligned:
        ops = [_offset_view(t, offset=4 if t.dtype == torch.float32 else 3) for t in ops]
    fn, on = getattr(hp, name), getattr(hp, name + "_on")
    want = getattr(hp, name + "_plain")(*ops)
    expect = "vec16" if aligned else "byte"
    assert hp.flat_kernel_for(*ops) == expect
    got, ran = _probe_kernels(fn, lambda: fn(*ops))
    assert ran == (expect,) and torch.equal(got, want)
    got, ran = _probe_kernels(fn, lambda: on("byte", *ops))
    assert ran == ("byte",) and torch.equal(got, want)
    with pytest.raises(ValueError, match="does not take"):
        on("vec16" if not aligned else "dp4a", *ops)


@pytest.mark.parametrize("four", [False, True])
def test_vit_predictor_fused_matches_module_on_card(cuda, four):
    """f32 on the card: the attention kernel and the library's matrix
    products agree to summation order (TF32 off), through Predictor."""
    cfg = Config(model_type=C.ALL_CAMS_18_POINTS_VIT if four
                 else C.MODEL_18_POINTS_PER_WING_VIT, projection_dim=64, num_heads=2,
                 transformer_layers=2, fully_connected_expand=2, compute_dtype="float32")
    shape, k = ((48, 48, 16), 8) if four else ((48, 48, 4), 6)
    params = init_vit_params(np.random.default_rng(0), shape[-1], k, 48, dim=64, depth=2,
                             heads=2, dim_head=64, mlp_expand=2, four_cameras=four)
    frames = np.random.default_rng(1).standard_normal((5, *shape)).astype(np.float32)
    before = ha.fused_attention.launches
    out = [Predictor(cfg, params, shape, k, device="cuda", chunk_size=2,
                     return_heatmaps=True, use_fused=f)(frames) for f in (False, True)]
    assert ha.fused_attention.launches == before + 3 * (2 + 4 if four else 2)
    np.testing.assert_allclose(out[1][0], out[0][0], atol=1e-4)
    np.testing.assert_allclose(out[1][1][:, 2], out[0][1][:, 2], atol=1e-4)


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernels and the wrappers' choice between kernels
# ---------------------------------------------------------------------------
def _stage_args(gen, b, h, w, cin, cout, dtype):
    args = [_rand(gen, b, h, w, cin).abs().to(dtype)]
    for c in (cin, cout, cout):
        args += [_rand(gen, 3, 3, c, cout, scale=(9 * c) ** -0.5).to(dtype),
                 _rand(gen, cout, scale=0.05)]
    return args


def _took(counter, fn):
    """(fn(), the names of the kernels it ran, from a by-kernel counter, each
    as often as it ran)."""
    before = dict(counter)
    out = fn()
    return out, tuple(sorted(k for k in counter for _ in range(counter[k] - before[k])))


@pytest.mark.parametrize("h, cin, cout, pool, kernels", [
    (192, 4, 64, True, ("mma_c4", "wgmma", "wgmma")),
    (96, 64, 128, True, ("wgmma", "wgmma", "wgmma")),
    (48, 128, 256, False, ("wgmma", "wgmma", "wgmma")),
    (192, 4, 64, False, ("mma_c4", "wgmma", "wgmma")),
    (96, 64, 128, False, ("wgmma", "wgmma", "wgmma")),
    (48, 128, 256, True, ("wgmma", "wgmma", "wgmma")),
])
def test_encoder_stage_flagship_shapes_on_tensor_cores(cuda, h, cin, cout, pool, kernels):
    """The three flagship stages at batch 2 in bf16, as served and with the
    pool the other way: every conv on a tensor-core kernel (the five
    distinct stride-1 shapes of the encoder on the wgmma kernel); the same
    call in float32 stays on the CUDA cores."""
    gen = torch.Generator(device="cuda").manual_seed(h)
    args = _stage_args(gen, 2, h, h, cin, cout, torch.bfloat16)
    by_kernel = hc.fused_encoder_stage.convs_by_kernel
    got, took = _took(by_kernel, lambda: hc.fused_encoder_stage(*args, dilation=2, pool=pool))
    assert took == tuple(sorted(kernels))
    _close(got, hc.fused_encoder_stage_plain(*args, dilation=2, pool=pool), torch.bfloat16)
    f32 = [a.float() for a in args]
    got, took = _took(by_kernel, lambda: hc.fused_encoder_stage(*f32, dilation=2, pool=pool))
    assert took == ("fma", "fma", "fma")
    _close(got, hc.fused_encoder_stage_plain(*f32, dilation=2, pool=pool), torch.float32)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_encoder_stage_bf16_error_holds_over_seeds(cuda, seed):
    """The deepest flagship stage (K = 9 x 256, the most sums to reorder)
    stays within the bf16 limit on other draws of weights and inputs."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args = _stage_args(gen, 4, 48, 48, 128, 256, torch.bfloat16)
    _close(hc.fused_encoder_stage(*args, dilation=2, pool=False),
           hc.fused_encoder_stage_plain(*args, dilation=2, pool=False), torch.bfloat16)


@pytest.mark.parametrize("b, h, w, cin, cout, dil, pool, kernels", [
    (2, 32, 32, 16, 64, 2, False, ("wgmma", "wgmma", "wgmma")),
    (1, 13, 17, 32, 72, 1, False, ("wgmma", "fma", "fma")),  # odd H x W, ragged Cout tile
    (2, 22, 38, 32, 32, 2, True, ("wgmma", "wgmma", "wgmma")),  # pooled, tile remainders 6 x 6
    (1, 40, 24, 48, 16, 8, True, ("wgmma", "wgmma", "wgmma")),  # the widest halo
    (3, 24, 24, 16, 136, 3, True, ("wgmma", "fma", "fma")),  # two Cout tiles, the last ragged
    (2, 20, 36, 4, 24, 2, False, ("mma_c4", "fma", "fma")),  # the packed first conv alone
    (2, 10, 50, 4, 8, 2, True, ("mma_c4", "fma", "fma")),    # pooled, remainders 10 x 2
    (2, 18, 34, 4, 32, 1, True, ("mma_c4", "wgmma", "wgmma")),  # dilation 1, remainders 2 x 2
    (1, 20, 44, 128, 256, 4, True, ("wgmma", "wgmma", "wgmma")),  # N 128, two patch slots
    (2, 30, 26, 80, 200, 5, False, ("wgmma", "fma", "fma")),  # one patch slot, Cin 80 of 128
    (2, 34, 18, 64, 64, 6, True, ("wgmma", "wgmma", "wgmma")),  # N 64, one patch slot
    (1, 17, 9, 16, 8, 7, False, ("wgmma", "fma", "fma")),    # one n8 block, a single tile
    (1, 24, 40, 128, 128, 7, True, ("wgmma", "wgmma", "wgmma")),  # N 128 at dilation 7
])
def test_encoder_stage_tensor_core_kernels_match_plain(cuda, b, h, w, cin, cout, dil, pool,
                                                       kernels):
    gen = torch.Generator(device="cuda").manual_seed(cin * cout + h)
    args = _stage_args(gen, b, h, w, cin, cout, torch.bfloat16)
    got, took = _took(hc.fused_encoder_stage.convs_by_kernel,
                      lambda: hc.fused_encoder_stage(*args, dilation=dil, pool=pool))
    assert took == tuple(sorted(kernels))
    _close(got, hc.fused_encoder_stage_plain(*args, dilation=dil, pool=pool), torch.bfloat16)


@pytest.mark.parametrize("cin, cout", [(4, 16), (16, 16), (9, 16)])
def test_nan_input_reaches_the_pooled_output(cuda, cin, cout):
    """The pool's max propagates NaN on every kernel, as the plain version's
    does: the same output elements are NaN, the others agree."""
    gen = torch.Generator(device="cuda").manual_seed(cin)
    args = _stage_args(gen, 1, 16, 16, cin, cout, torch.bfloat16)
    args[0][0, 5, 5, 1] = float("nan")
    got = hc.fused_encoder_stage(*args, pool=True)
    want = hc.fused_encoder_stage_plain(*args, pool=True)
    assert got.isnan().any() and not got.isnan().all()
    assert torch.equal(got.isnan(), want.isnan())
    _close(got.nan_to_num(0.0), want.nan_to_num(0.0), torch.bfloat16)


def test_decoder_stride1_convs_on_tensor_cores(cuda):
    gen = torch.Generator(device="cuda").manual_seed(5)
    for mid, kernel in ((128, "wgmma"), (40, "fma")):
        args = [_rand(gen, 2, 12, 12, 256).abs().bfloat16()]
        for ci, co in ((256, mid), (mid, mid), (mid, mid), (mid, 18)):
            args += [_rand(gen, 3, 3, ci, co, scale=(9 * ci) ** -0.5).bfloat16(),
                     _rand(gen, co, scale=0.05)]
        got, took = _took(hd.fused_decoder.convs_by_kernel, lambda: hd.fused_decoder(*args))
        assert took == (kernel, kernel)
        _close(got, hd.fused_decoder_plain(*args), torch.bfloat16)
    f32 = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
    assert _took(hd.fused_decoder.convs_by_kernel,
                 lambda: hd.fused_decoder(*f32))[1] == ("fma", "fma")


@pytest.mark.parametrize("b, heads, n", [(6, 8, 144), (6, 4, 144), (3, 4, 576), (2, 8, 1)])
def test_attention_views_take_the_kernel_the_rule_names(cuda, b, heads, n):
    """The ViT's views (q, k, v slices of one qkv tensor, a permuted output
    view) at the encoder's 8 heads and the fusion block's 4: the tensor-core
    kernel in bf16 up to 144 tokens, the CUDA-core kernel beyond and in
    float32."""
    d = 256
    gen = torch.Generator(device="cuda").manual_seed(n)
    for dtype in (torch.bfloat16, torch.float32):
        qkv = _rand(gen, b, n, 3, heads, d).to(dtype)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        out = torch.full((b, n, heads, d), float("nan"), dtype=dtype, device="cuda")
        want = "mma" if dtype == torch.bfloat16 and n <= 144 else "fma"
        assert want == ha.attention_kernel_for(dtype, n, d)
        _, took = _took(ha.fused_attention.launches_by_kernel,
                        lambda: ha.fused_attention(q, k, v, out=out.permute(0, 2, 1, 3)))
        assert took == (want,)
        _close(out.permute(0, 2, 1, 3), ha.fused_attention_plain(q, k, v), dtype)


@pytest.mark.parametrize("g, n, d", [
    (300, 144, 256),  # more g than resident blocks: the ring runs several rounds
    (1, 144, 256), (7, 33, 32), (5, 100, 80), (3, 7, 16), (9, 129, 48),
])
def test_attention_tensor_core_kernel_matches_plain(cuda, g, n, d):
    gen = torch.Generator(device="cuda").manual_seed(g * n + d)
    q, k, v = (_rand(gen, g, n, d).bfloat16() for _ in range(3))
    got, took = _took(ha.fused_attention.launches_by_kernel,
                      lambda: ha.fused_attention(q, k, v))
    assert took == ("mma",)
    _close(got, ha.fused_attention_plain(q, k, v), torch.bfloat16)


def test_shared_memory_figures_are_the_kernels_own(cuda):
    """The byte counts the dispatch rules reckon with are the ones the built
    libraries launch with."""
    assert hc.conv_c4_smem_bytes() == hc.conv_c4_smem_bytes_built()
    for n, d in [(144, 256), (129, 256), (1, 16), (100, 80), (144, 272)]:
        assert ha.attention_mma_smem_bytes(n, d) == ha.attention_mma_smem_bytes_built(n, d)
    assert hd.up2_mma_smem_bytes() == hd.up2_mma_smem_bytes_built()
    for dil in range(1, hc.MAX_DILATION + 1):
        assert hq.qconv_mma_smem_bytes(dil) == hq.qconv_mma_smem_bytes_built(dil)


def test_named_kernel_runs_and_a_wrong_name_is_refused(cuda):
    """The CUDA-core kernels on shapes the rules give the tensor cores: the
    same answers; a tensor-core kernel named for a shape it does not take
    raises."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    args = _stage_args(gen, 2, 32, 32, 16, 64, torch.bfloat16)
    got, took = _took(hc.fused_encoder_stage.convs_by_kernel,
                      lambda: hc.fused_encoder_stage_on(("fma",) * 3, *args, pool=True))
    assert took == ("fma",) * 3
    _close(got, hc.fused_encoder_stage_plain(*args, pool=True), torch.bfloat16)
    with pytest.raises(ValueError, match="does not take"):
        hc.fused_encoder_stage_on(("mma_c4", "wgmma", "wgmma"), *args, pool=True)
    q, k, v = (_rand(gen, 4, 144, 64).bfloat16() for _ in range(3))
    got, took = _took(ha.fused_attention.launches_by_kernel,
                      lambda: ha.fused_attention_on("fma", q, k, v))
    assert took == ("fma",)
    _close(got, ha.fused_attention_plain(q, k, v), torch.bfloat16)
    with pytest.raises(ValueError, match="does not take"):
        ha.fused_attention_on("mma", q.float(), k.float(), v.float())


# ---------------------------------------------------------------------------
# the stride-2 tensor-core kernel of the decoder, the int8 tensor-core conv
# ---------------------------------------------------------------------------
def _decoder_args(gen, b, r, w, cin, mid, k, dtype=torch.bfloat16):
    args = [_rand(gen, b, r, w, cin).abs().to(dtype)]
    for ci, co in ((cin, mid), (mid, mid), (mid, mid), (mid, k)):
        args += [_rand(gen, 3, 3, ci, co, scale=(9 * ci) ** -0.5).to(dtype),
                 _rand(gen, co, scale=0.05)]
    return args


@pytest.mark.parametrize("b, r, w, cin, mid, k", [
    (2, 13, 10, 48, 24, 5),     # ragged tiles; the head (Cin 24) stays on the CUDA cores
    (2, 13, 10, 48, 32, 5),     # K = 5: odd, staged and stored by element
    (2, 13, 10, 9, 24, 5),      # both layers on the CUDA cores
    (1, 12, 12, 256, 128, 18),  # the flagship widths: four channel tiles, then K = 18
    (2, 5, 7, 32, 48, 70),      # K = 70: three channel tiles, the last of 6, by element
    (3, 17, 33, 32, 64, 18),    # three column tiles, the last one pixel wide
    (2, 20, 20, 64, 80, 40),    # channel tiles of 32, 32, 16 and 32, 8
    (1, 8, 16, 16, 16, 8),      # exactly one tile
    (2, 9, 18, 16, 32, 6),      # K = 6 with 2 W K = 216: whole rows by 16 bytes
    (2, 9, 17, 16, 32, 6),      # ... and with rows off the 16 bytes: by element
])
def test_decoder_stride2_kernels_match_plain(cuda, b, r, w, cin, mid, k):
    gen = torch.Generator(device="cuda").manual_seed(cin * mid + k + w)
    args = _decoder_args(gen, b, r, w, cin, mid, k)
    got, took = _took(hd.fused_decoder.up2_by_kernel, lambda: hd.fused_decoder(*args))
    want = tuple(sorted([hd.up2_kernel_for(torch.bfloat16, cin, mid),
                         hd.up2_kernel_for(torch.bfloat16, mid, k)]))
    assert took == want
    assert got.shape == (b, 4 * r, 4 * w, k)
    _close(got, hd.fused_decoder_plain(*args), torch.bfloat16)
    f32 = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
    got, took = _took(hd.fused_decoder.up2_by_kernel, lambda: hd.fused_decoder(*f32))
    assert took == ("fma", "fma")
    _close(got, hd.fused_decoder_plain(*f32), torch.float32)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_decoder_bf16_error_holds_over_seeds(cuda, seed):
    """The served decoder widths (256 -> 128 -> 18, a 48 x 48 latent) stay
    within the bf16 limit on other draws of weights and inputs."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args = _decoder_args(gen, 2, 48, 48, 256, 128, 18)
    got, took = _took(hd.fused_decoder.up2_by_kernel, lambda: hd.fused_decoder(*args))
    assert took == ("mma", "mma")
    _close(got, hd.fused_decoder_plain(*args), torch.bfloat16)


def test_decoder_named_kernels_run_and_a_wrong_name_is_refused(cuda):
    gen = torch.Generator(device="cuda").manual_seed(3)
    args = _decoder_args(gen, 2, 12, 12, 64, 32, 18)
    want = hd.fused_decoder_plain(*args)
    for up2 in (("fma", "fma"), ("mma", "fma"), ("fma", "mma"), ("mma", "mma")):
        got, took = _took(hd.fused_decoder.up2_by_kernel,
                          lambda: hd.fused_decoder_on("wgmma", up2, *args))
        assert took == tuple(sorted(up2))
        _close(got, want, torch.bfloat16)
    f32 = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
    with pytest.raises(ValueError, match="does not take"):
        hd.fused_decoder_on("fma", ("mma", "fma"), *f32)


def _qstage_args(rng, b, h, w, cin, cout):
    args = [_int8(rng, b, h, w, cin)]
    for c in (cin, cout, cout):
        args += _dequant_args(rng, c, cout)
    return args, [float(v) for v in rng.uniform(20, 40, 3)]


@pytest.mark.parametrize("b, h, w, cin, cout, dil, pool, kernels", [
    (2, 40, 52, 32, 40, 1, True, ("dp4a", "dp4a", "mma_s8")),   # ragged tiles
    (2, 40, 52, 32, 40, 3, False, ("dp4a", "dp4a", "mma_s8")),
    (2, 40, 52, 32, 96, 3, True, ("mma_s8",) * 3),    # the last channel tile half full
    (2, 20, 36, 64, 64, 2, True, ("mma_s8",) * 3),
    (1, 13, 17, 32, 8, 1, False, ("dp4a", "dp4a", "mma_s8")),   # one n8 tile of eight
    (3, 24, 24, 64, 136, 8, True, ("dp4a", "dp4a", "mma_s8")),  # the widest halo
    (1, 96, 96, 64, 128, 2, True, ("mma_s8",) * 3),   # flagship stages 2 and 3
    (1, 48, 48, 128, 256, 2, False, ("mma_s8",) * 3),
    (2, 20, 36, 4, 32, 2, True, ("mma_s8_c4", "mma_s8", "mma_s8")),  # as flagship stage 1
    (1, 30, 21, 4, 72, 8, False, ("mma_s8_c4", "dp4a", "dp4a")),  # ragged, the widest halo
])
def test_quantized_stage_tensor_core_kernel_equals_plain(cuda, b, h, w, cin, cout, dil,
                                                         pool, kernels):
    rng = np.random.default_rng(cin * cout + dil + h)
    args, invs = _qstage_args(rng, b, h, w, cin, cout)
    got, took = _took(hq.fused_quantized_stage.convs_by_kernel,
                      lambda: hq.fused_quantized_stage(*args, *invs, dilation=dil, pool=pool))
    torch.cuda.synchronize()
    assert took == tuple(sorted(kernels))
    want = hq.fused_quantized_stage_plain(*args, *invs, dilation=dil, pool=pool)
    assert 5 < want.float().abs().mean() < 64  # the int8 range is used, unsaturated
    assert torch.equal(got, want)
    # the CUDA-core kernel on the same tensors, named; packed weights handed over
    packed = [args[0]] + [hq.pack_qconv_weights(a) if a.dtype == torch.int8 else a
                          for a in args[1:]]
    old = hq.fused_quantized_stage_on(("dp4a",) * 3, *packed, *invs, dilation=dil, pool=pool)
    assert torch.equal(old, want)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_quantized_stage_equals_plain_over_seeds(cuda, seed):
    """The deepest flagship stage (128 -> 256 -> 256) on other draws."""
    rng = np.random.default_rng(seed)
    args, invs = _qstage_args(rng, 2, 48, 48, 128, 256)
    got = hq.fused_quantized_stage(*args, *invs, dilation=2, pool=False)
    assert torch.equal(got, hq.fused_quantized_stage_plain(*args, *invs, dilation=2, pool=False))


@pytest.mark.parametrize("b, h, w, cin, cout, dil, kernel", [
    (2, 24, 40, 64, 64, 2, "mma_s8"),
    (1, 11, 33, 160, 72, 8, "mma_s8"),
    (1, 17, 19, 32, 8, 1, "mma_s8"),
    (2, 16, 16, 12, 70, 3, "dp4a"),
    (2, 19, 40, 4, 64, 2, "mma_s8_c4"),
    (1, 16, 16, 4, 8, 1, "mma_s8_c4"),
])
def test_quantized_conv3x3_takes_the_kernel_the_rule_names(cuda, b, h, w, cin, cout, dil,
                                                           kernel):
    rng = np.random.default_rng(h + cin)
    mult = torch.from_numpy((rng.uniform(5e-4, 2e-3, cout) * 64 / cin).astype(np.float32)).cuda()
    bias = torch.from_numpy(rng.uniform(-0.1, 0.1, cout).astype(np.float32)).cuda()
    x, wq = _int8(rng, b, h, w, cin, lim=80), _int8(rng, 3, 3, cin, cout, lim=90)
    assert hq.qconv_kernel_for(cin, cout, dil) == kernel
    got, took = _took(hq.quantized_conv3x3.launches_by_kernel,
                      lambda: hq.quantized_conv3x3(x, wq, mult, bias, dilation=dil))
    assert took == (kernel,)
    want = hq.quantized_conv3x3_plain(x, wq, mult, bias, dilation=dil)
    assert torch.equal(got, want)
    assert torch.equal(
        hq.quantized_conv3x3_on("dp4a", x, hq.pack_qconv_weights(wq), mult, bias,
                                dilation=dil), want)
    if kernel == "dp4a":
        with pytest.raises(ValueError, match="does not take"):
            hq.quantized_conv3x3_on("mma_s8", x, wq, mult, bias, dilation=dil)
        with pytest.raises(ValueError, match="does not take"):
            hq.quantized_conv3x3_on("mma_s8_c4", x, wq, mult, bias, dilation=dil)


@pytest.mark.parametrize("cin, cout", [(4, 64), (9, 7), (64, 64), (130, 24)])
def test_pack_qconv_weights_kernel_equals_plain(cuda, cin, cout):
    w = _int8(np.random.default_rng(cin), 3, 3, cin, cout, lim=127)
    before = hq.pack_qconv_weights.launches
    got = hq.pack_qconv_weights(w)
    assert hq.pack_qconv_weights.launches == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == hq.packed_shape(cin, cout)
    assert torch.equal(got, hq.pack_qconv_weights_plain(w))
    assert torch.equal(got.cpu(), hq.pack_qconv_weights(w.cpu()))
    with pytest.raises(ValueError, match="shape"):
        hq.fused_quantized_stage(_int8(np.random.default_rng(0), 1, 8, 8, cin + 4),
                                 got, *([torch.zeros(cout, device="cuda")] * 2),
                                 *([got, torch.zeros(cout, device="cuda"),
                                    torch.zeros(cout, device="cuda")] * 2), 1.0, 1.0, 1.0)


def test_encoder_stage_times_at_the_served_chunk(cuda, capsys):
    """The three flagship stages in bf16 at batch 256, timed and printed (run
    with -s to read them): the tensor-core conv kernel shares its headers
    with the decoder's and the int8 kernels, and its times must not move
    with theirs. The bound is loose: a card below its full power limit is
    slower, the CUDA-core kernel took ten times as long."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = []
    for h, cin, cout, pool in ((192, 4, 64, True), (96, 64, 128, True), (48, 128, 256, False)):
        args = _stage_args(gen, 256, h, h, cin, cout, torch.bfloat16)
        hc.fused_encoder_stage(*args, dilation=2, pool=pool)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(5):
            hc.fused_encoder_stage(*args, dilation=2, pool=pool)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 5)
        del args
    with capsys.disabled():
        print(f"\nfused_encoder_stage bf16 batch 256, ms a stage: "
              f"{times[0]:.3f} / {times[1]:.3f} / {times[2]:.3f} on "
              f"{torch.cuda.get_device_name(0)}")
    assert all(t < 12.0 for t in times), times


# ---- training on the card ---------------------------------------------------

def _train_setup(dev, **kw):
    from pose_estimation_amitai_torch.models import build_model
    from pose_estimation_amitai_torch.train import loop

    cfg = Config(num_base_filters=8, **kw)
    rng = np.random.default_rng(0)
    data = {"box": torch.from_numpy(rng.random((8, 48, 48, 4), np.float32)),
            "peaks": torch.from_numpy(rng.uniform(4, 44, (8, 6, 2)).astype(np.float32)),
            "peak_vals": torch.ones(8, 6)}
    model = build_model(cfg, (48, 48, 4), 6)
    return cfg, model, {k: v.to(dev) for k, v in data.items()}, loop


def test_training_forward_on_card_draws_dropout_on_card(cuda):
    cfg, model, data, loop = _train_setup(cuda)
    state = loop.create_train_state(model, cfg, device=cuda)
    model.train()
    from torch.func import functional_call

    def fwd(seed):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        return functional_call(model, state.params, (data["box"],), {"generator": gen})

    a = fwd(1)
    assert a.is_cuda and a.dtype == torch.float32 and bool(torch.isfinite(a).all())
    assert torch.equal(a, fwd(1)) and not torch.equal(a, fwd(2))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_on_card_matches_cpu(cuda, accum):
    """float32, TF32 off, dropout 0, targets from peaks: the card's step
    against the CPU's, loss within 1e-4 relative, gradients within 1e-3 of
    their max, parameters within 1e-6 wherever the gradients agree in sign,
    beyond what the gradients' difference moves Adam's first update
    (lr * g / (|g| + eps), chip_smoke.py's train phase)."""
    cfg, model, data, loop = _train_setup(cuda, compute_dtype="float32", dropout_ratio=0.0,
                                          do_augmentations=False, accumulation_steps=accum)
    idx = np.arange(4 * accum, dtype=np.int32).reshape(accum, 4)
    step, grad_fn = loop.make_train_step(model, cfg), loop.make_grad_fn(model, cfg)
    out = {}
    torch.backends.cudnn.deterministic = True  # the step's gradients are grad_fn's
    try:
        for dev, d in ((cuda, data), ("cpu", {k: v.cpu() for k, v in data.items()})):
            st = loop.create_train_state(model, cfg, device=dev)
            g = [grad_fn(st.params, d, i, torch.Generator(device=dev))[1] for i in idx]
            new, loss = step(st, d, idx)
            out[str(dev)] = (float(loss),
                             {k: sum(x[k] for x in g).cpu() / accum for k in g[0]},
                             {k: v.cpu() for k, v in new.params.items()})
    finally:
        torch.backends.cudnn.deterministic = False
    (lg, gg, pg), (lc, gc, pc) = out["cuda"], out["cpu"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for k in gc:
        same = torch.sign(gg[k]) == torch.sign(gc[k])
        assert float((gg[k] - gc[k]).abs().max()) <= 1e-3 * float(gc[k].abs().max()), k
        eps = 1e-8
        explained = cfg.learning_rate * eps * (gg[k] - gc[k]).abs() / (
            (gg[k].abs() + eps) * (gc[k].abs() + eps))
        assert float(((pg[k] - pc[k]).abs() - explained)[same].max()) <= 1e-6, k


def test_train_steps_on_card_resume_exactly(cuda, tmp_path):
    from pose_estimation_amitai_torch.train import checkpoint

    cfg, model, data, loop = _train_setup(cuda, wings_masks_dilation=3)
    step = loop.make_train_step(model, cfg)
    idx = [np.random.default_rng(i).integers(0, 8, (1, 4)).astype(np.int32) for i in range(4)]
    torch.backends.cudnn.deterministic = True
    try:
        whole = loop.create_train_state(model, cfg, device=cuda)
        part = whole
        for i in range(4):
            whole, _ = step(whole, data, idx[i])
        for i in range(2):
            part, _ = step(part, data, idx[i])
        checkpoint.save_checkpoint(str(tmp_path), part, 0, 0.0)
        part, _ = checkpoint.restore_checkpoint(
            str(tmp_path), loop.create_train_state(model, cfg, seed=5, device=cuda))
        for i in range(2, 4):
            part, _ = step(part, data, idx[i])
    finally:
        torch.backends.cudnn.deterministic = False
    assert all(torch.equal(whole.params[k], part.params[k]) for k in whole.params)
    assert all(v.is_cuda for v in part.params.values())


# ---------------------------------------------------------------------------
# the separable warp (no hand-written kernel: the card's library ops against
# the CPU's; the coordinates are the same bits on both)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [96, 192])
def test_separable_warp_on_card_matches_cpu(cuda, hw, dtype):
    """float32 within 1e-5; bf16 within 0.02, the bound its CPU test holds
    the port to JAX by (tests/test_torch_affine_separable.py)."""
    from pose_estimation_amitai_torch.ops import affine

    gen = torch.Generator().manual_seed(hw)
    images = torch.rand((6, hw, hw, 4), generator=gen).to(dtype)
    p = affine.sample_augment_params(gen, 6, rotation_range=180.0, xy_shifts=10.0,
                                     zoom_range=(0.9, 1.1))
    mats = affine.make_affine_matrix(p, hw, hw)
    torch.testing.assert_close(affine._inverse(mats.to(cuda)).cpu(), affine._inverse(mats),
                               rtol=0, atol=0)
    for limit in (affine._shear_limit(10.0), 1.0):
        got = affine.affine_warp_separable_batch(images.to(cuda), mats.to(cuda), 1,
                                                 shear_limit=limit)
        want = affine.affine_warp_separable_batch(images, mats, 1, shear_limit=limit)
        assert got.is_cuda and got.dtype == dtype and got.shape == images.shape
        err = float((got.cpu().float() - want.float()).abs().max())
        assert err <= (1e-5 if dtype == torch.float32 else 0.02), (limit, err)


def test_bucketed_augment_on_card_draws_as_on_cpu(cuda):
    """A bucketed ``augment_views_and_peaks`` at 192 px on the card draws
    its bucket first, then the rows, as on the CPU: a replay of those
    draws from the same seed gives its matrices, and the CPU's warp on
    them its frames."""
    from pose_estimation_amitai_torch.ops import affine, draws

    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((4, 192, 192, 4), np.float32))
    pk = torch.from_numpy(rng.uniform(30, 160, (4, 6, 2)).astype(np.float32))
    buckets = affine.rotation_buckets(30.0)
    seen = set()
    for seed in range(6):
        warped, maps, mats = affine.augment_views_and_peaks(
            torch.Generator(device=cuda).manual_seed(seed), images.to(cuda), pk.to(cuda),
            torch.ones((4, 6), device=cuda), rotation_range=30.0)
        gen = torch.Generator(device=cuda).manual_seed(seed)
        lo, hi, quad = buckets[draws.scalar_randint(3, gen, cuda)]
        seen.add(hi)
        p = affine.sample_augment_params(gen, 4, rotation_range=hi, rotation_low=lo,
                                         quadrants=quad)
        torch.testing.assert_close(mats.reshape(4, 3, 3),
                                   affine.make_affine_matrix(p, 192, 192), rtol=0, atol=0)
        want = affine.affine_warp_separable_batch(images, mats.reshape(4, 3, 3).cpu(), 1,
                                                  shear_limit=affine._shear_limit(hi))
        assert float((warped.cpu() - want).abs().max()) <= 1e-5
        assert maps.is_cuda and bool(torch.isfinite(maps).all())
    assert len(seen) >= 2, seen


# ---------------------------------------------------------------------------
# the BatchNorm families and the camera-matrix model (no hand-written kernel:
# the card's library ops against the CPU's)
# ---------------------------------------------------------------------------
def test_batchnorm_on_card_matches_cpu(cuda):
    """flax's BatchNorm: a bf16 training-mode forward twice (the shared
    module's updates), then eval, on the card as on the CPU."""
    from pose_estimation_amitai_torch.models.norm import BatchNorm, collect_batch_stats

    gen = torch.Generator().manual_seed(0)
    xs = [(torch.randn(4, 40, 9, 11, generator=gen) * 3 + 1).to(torch.bfloat16)
          for _ in range(2)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        bn = BatchNorm(40)
        with torch.no_grad():
            bn.weight.add_(0.1), bn.bias.sub_(0.2)
        bn = bn.to(dev).train()
        with torch.no_grad(), collect_batch_stats() as upd:
            ys = [bn(x.to(dev)) for x in xs]
        assert bn.running_var.eq(1).all()  # collected, not written
        (mean, var), = upd.values()
        bn.running_mean, bn.running_var = mean, var
        with torch.no_grad():
            ys.append(bn.eval()(xs[0].to(dev)))
        out[dev.type] = [t.cpu() for t in (*ys, mean, var)]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_cubic_resize_and_ftl_on_card_match_cpu(cuda):
    from pose_estimation_amitai_torch.models.resnet import cubic_resize
    from pose_estimation_amitai_torch.ops.geometry import ftl_inverse, ftl_project

    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 6, 96, 96, generator=gen)
    torch.testing.assert_close(cubic_resize(x.to(cuda), (192, 192)).cpu(),
                               cubic_resize(x, (192, 192)), rtol=1e-5, atol=1e-5)
    latent = torch.randn(2, 12, 12, 300, generator=gen)
    P = torch.randn(2, 3, 4, generator=gen)
    P_inv = torch.linalg.pinv(P)
    lifted = ftl_inverse(latent.to(cuda), P_inv.to(cuda))
    torch.testing.assert_close(lifted.cpu(), ftl_inverse(latent, P_inv), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ftl_project(lifted, P.to(cuda)).cpu(),
                               ftl_project(ftl_inverse(latent, P_inv), P),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model_type, shape, k", [
    (C.ALL_CAMS_DISENTANGLED_PER_WING_CNN, (96, 96, 16), 24),
    (C.GPTNET, (96, 96, 4), 6),
    (C.RESNET_18_POINTS_PER_WING, (96, 96, 4), 6),
])
def test_batchnorm_families_serve_on_card_as_on_cpu(cuda, model_type, shape, k):
    """Predictor on the card (channels-last weights) against the CPU on
    the same variables, float32 with TF32 off; the disentangled model with
    its cameras, 5 samples in chunks of 2 (the padded tail's camera row the
    last sample's); the bridge tells GPTResNet's ``up1`` (64 -> 64, 2x2,
    equal OIHW and IOHW shapes) by its type."""
    from pose_estimation_amitai_torch import weights
    from pose_estimation_amitai_torch.models import build_model
    from pose_estimation_amitai_torch.train import loop

    cfg = Config(model_type=model_type, num_base_filters=8, compute_dtype="float32")
    with torch.device("meta"):
        model = build_model(cfg, shape, k)
    state = loop.create_train_state(model, cfg, seed=4, device="cpu")
    gen = torch.Generator().manual_seed(5)
    params = weights.state_dict_to_flax(
        {n: v + 0.05 * torch.randn(v.shape, generator=gen) if v.dim() == 1 else v
         for n, v in state.params.items()}, model)
    stats = weights.batch_stats_to_flax(
        {n: 0.5 + torch.rand(v.shape, generator=gen) if n.endswith("var")
         else 0.1 * torch.randn(v.shape, generator=gen) for n, v in state.batch_stats.items()})
    frames = torch.rand(5, *shape, generator=gen).numpy()
    cams = None
    if shape[-1] == 16:
        P = torch.randn(5, 4, 3, 4, generator=gen)
        cams = (P.numpy(), torch.linalg.pinv(P).numpy())
    maps = {}
    for dev in (cuda, torch.device("cpu")):
        pred = Predictor(cfg, params, shape, k, device=dev, chunk_size=2, return_heatmaps=True,
                         batch_stats=stats, cameras=cams)
        assert pred.serving_path == "module"
        maps[dev.type] = pred(frames)[0]
    top = np.abs(maps["cpu"]).max()
    assert np.abs(maps["cuda"] - maps["cpu"]).max() <= 1e-4 * max(top, 1.0)


# ---------------------------------------------------------------------------
# ViT training and generic int8 serving (no hand-written kernel: the card's
# library ops against the CPU's)
# ---------------------------------------------------------------------------
_SMALL_VIT = dict(model_type=C.MODEL_18_POINTS_PER_WING_VIT, patch_size=16, projection_dim=32,
                  transformer_layers=2, num_heads=2, fully_connected_expand=2, dim_head=0)


@pytest.mark.parametrize("flavor", ["torch", "tf"])
def test_vit_train_step_on_card_matches_cpu(cuda, flavor):
    """One float32 step of a small ViT (TF32 off, dropout 0, targets from
    peaks; the tf flavour's attention dropout set to 0 on the instances):
    loss within 1e-4 relative, gradients within 1e-3 of the largest,
    chip_smoke.py's train-phase tolerances."""
    from pose_estimation_amitai_torch.models import vit

    cfg, model, data, loop = _train_setup(cuda, compute_dtype="float32", dropout_ratio=0.0,
                                          do_augmentations=False, arch_flavor=flavor,
                                          **_SMALL_VIT)
    for m in model.modules():
        if isinstance(m, vit.Attention):
            m.dropout = 0.0
    idx = np.arange(4, dtype=np.int32)
    out = {}
    for dev, d in ((cuda, data), ("cpu", {k: v.cpu() for k, v in data.items()})):
        st = loop.create_train_state(model, cfg, device=dev)
        loss, grads = loop.make_grad_fn(model, cfg)(st.params, d, idx,
                                                    torch.Generator(device=dev))
        out[str(dev)] = (float(loss), {k: g.cpu() for k, g in grads.items()})
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    top = max(float(g.abs().max()) for g in gc.values())
    for k in gc:
        assert float((gg[k] - gc[k]).abs().max()) <= 1e-3 * top, k


def test_int8_generic_vit_on_card_matches_cpu(cuda):
    """A small ViTPoseNet on "int8_generic": the calibration scales card vs
    CPU in float32 within 1e-5 relative; with the CPU's scales on both, each
    quantised layer gives the CPU's bits on the CPU's input (the float64
    sums of int8 products are exact, the epilogue is the same float32
    arithmetic); the Predictor serves it on the card."""
    from pose_estimation_amitai_torch import weights
    from pose_estimation_amitai_torch.models import build_model
    from pose_estimation_amitai_torch.models import quantized_generic as qg

    cfg = Config(**_SMALL_VIT)
    params = init_vit_params(np.random.default_rng(0), 4, 6, 48, dim=32, depth=2, heads=2,
                             dim_head=64, mlp_expand=2)
    frames = np.random.default_rng(1).random((8, 48, 48, 4), dtype=np.float32)

    def model_on(c, dev):
        m = build_model(c, (48, 48, 4), 6, normalize_output=False).to(dev).eval()
        state = {k: v.to(dev) for k, v in weights.flax_to_state_dict(params, m).items()}
        m.load_state_dict(state)
        return m, state, qg.calibration_batches(frames, device=dev)

    scales = {dev: qg.calibrate_apply(*model_on(cfg.replace(compute_dtype="float32"), dev))
              for dev in ("cuda", "cpu")}
    assert sorted(scales["cuda"]) == sorted(scales["cpu"]) and len(scales["cpu"]) == 13
    for k, v in scales["cpu"].items():
        assert abs(scales["cuda"][k] - v) <= 1e-5 * v, k
    q, sc = {}, None  # the CPU's scales of the bf16 model, on both devices
    for dev in ("cpu", "cuda"):
        m, state, batches = model_on(cfg, dev)
        if sc is None:
            sc = qg.calibrate_apply(m, state, batches)
        q[dev] = qg.quantize_model(m, state, sc)
    seen = []
    hooks = [mod.register_forward_hook(lambda mod, a, o, p=p: seen.append((p, a[0], o)))
             for p, mod in q["cpu"].named_modules() if isinstance(mod, qg.QuantizedLayer)]
    with torch.no_grad():
        q["cpu"](torch.from_numpy(frames[:2]))
        for h in hooks:
            h.remove()
        card = dict(q["cuda"].named_modules())
        assert len(seen) == 13
        for p, x, want in seen:
            assert torch.equal(card[p](x.to(cuda)).cpu(), want), p
    pred = Predictor(cfg, params, (48, 48, 4), 6, device=cuda, chunk_size=4,
                     use_quantized=True, calibration_frames=frames)
    assert pred.serving_path == "int8_generic"
    pts = pred(frames)
    assert pts.shape == (8, 3, 6) and np.isfinite(pts).all()


# ---------------------------------------------------------------------------
# the custom ops (ops/custom_ops.py) and the exported serving artifact
# ---------------------------------------------------------------------------
def test_custom_ops_equal_their_wrappers_on_card(cuda):
    """Each op launches its wrapper's kernel, once a call, with the
    wrapper's result, bit for bit."""
    from pose_estimation_amitai_torch.ops import custom_ops

    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    x = _rand(gen, 2, 24, 24, 4).abs().to(bf)
    w1 = _rand(gen, 3, 3, 4, 64, scale=0.2).to(bf)
    w2 = _rand(gen, 3, 3, 64, 64, scale=0.05).to(bf)
    b = _rand(gen, 64, scale=0.05)
    before = hc.fused_encoder_stage.launches
    got = custom_ops.fused_encoder_stage(x, w1, b, w2, b, w2, b, 2, 0.1, True)
    assert hc.fused_encoder_stage.launches == before + 1
    assert torch.equal(got, hc.fused_encoder_stage(x, w1, b, w2, b, w2, b, dilation=2,
                                                   alpha=0.1, pool=True))
    lat = _rand(gen, 2, 6, 6, 64).abs().to(bf)
    w4 = _rand(gen, 3, 3, 64, 18, scale=0.05).to(bf)
    b4 = _rand(gen, 18, scale=0.05)
    before = hd.fused_decoder.launches
    got = custom_ops.fused_decoder(lat, w2, b, w2, b, w2, b, w4, b4, 0.1)
    assert hd.fused_decoder.launches == before + 1
    assert torch.equal(got, hd.fused_decoder(lat, w2, b, w2, b, w2, b, w4, b4, alpha=0.1))
    q = torch.randint(-60, 60, (2, 24, 24, 4), generator=gen, device="cuda", dtype=torch.int8)
    qw1 = torch.randint(-100, 100, (3, 3, 4, 64), generator=gen, device="cuda", dtype=torch.int8)
    qw2 = torch.randint(-100, 100, (3, 3, 64, 64), generator=gen, device="cuda",
                        dtype=torch.int8)
    m = _rand(gen, 64).abs() * 1e-4
    args = (q, qw1, m, b, qw2, m, b, qw2, m, b)
    before = hq.fused_quantized_stage.launches
    got = custom_ops.fused_quantized_stage(*args, 30.0, 30.0, 30.0, 2, 0.1, True)
    assert hq.fused_quantized_stage.launches == before + 1
    assert torch.equal(got, hq.fused_quantized_stage(*args, 30.0, 30.0, 30.0, dilation=2,
                                                     alpha=0.1, pool=True))
    qkv = _rand(gen, 3, 144, 3, 8, 64).to(bf)
    before = ha.fused_attention.launches
    got = custom_ops.fused_attention(qkv)
    assert ha.fused_attention.launches == before + 1
    want = ha.fused_attention(*(qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3)))
    assert torch.equal(got, want.permute(0, 2, 1, 3))


def test_loaded_fused_program_launches_the_kernels(cuda, tmp_path):
    """The flagship's fused route exported on the card and loaded: each
    chunk launches the three encoder stages and the decoder, and its peaks
    are the Predictor's."""
    from pose_estimation_amitai_torch.deploy import export_predictor, load_exported

    params = init_basicnet_params(np.random.default_rng(0), 4, 18, filters=16)
    pred = Predictor(Config(num_base_filters=16), params, (64, 64, 4), 18, device="cuda",
                     chunk_size=8, use_fused=True)
    assert pred.serving_path == "fused"
    path = str(tmp_path / "m.ptexp")
    export_predictor(pred, path)
    loaded = load_exported(path, "cuda")
    frames = np.random.default_rng(1).random((11, 64, 64, 4), dtype=np.float32)
    e0, d0 = hc.fused_encoder_stage.launches, hd.fused_decoder.launches
    got = loaded(frames)
    torch.cuda.synchronize()
    assert hc.fused_encoder_stage.launches - e0 == 6 and hd.fused_decoder.launches - d0 == 2
    np.testing.assert_array_equal(got, pred(frames))


# ---------------------------------------------------------------------------
# the parallel strategies on a one-rank NCCL group (one card: degree 1)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def nccl_group():
    """A one-process NCCL group on card 0 for the module's parallel cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    yield
    dist.destroy_process_group()


def test_sharded_step_on_nccl_equals_plain_step(cuda, nccl_group):
    """The data-parallel step at degree 1 (augmentation, mask re-dilation
    and dropout on) against the plain step on the same batch."""
    from pose_estimation_amitai_torch.parallel.mesh import make_mesh
    from pose_estimation_amitai_torch.parallel.sharded import make_sharded_train_step, shard_state

    cfg, model, data, loop = _train_setup(cuda, wings_masks_dilation=3, accumulation_steps=2)
    data["confmaps"] = torch.zeros(8, 48, 48, 6, device=cuda)
    idx = np.arange(8, dtype=np.int32).reshape(2, 4)
    mesh = make_mesh((1,), "cuda")
    batch = {("image" if k == "box" else k): v[torch.from_numpy(idx).long().to(cuda)]
             for k, v in data.items()}
    torch.backends.cudnn.deterministic = True
    try:
        state = loop.create_train_state(model, cfg, device=cuda)
        want, wl = loop.make_train_step(model, cfg)(state, data, idx)
        got, gl = make_sharded_train_step(model, cfg, mesh)(shard_state(mesh, state), batch)
    finally:
        torch.backends.cudnn.deterministic = False
    assert abs(float(gl) - float(wl)) <= 1e-6 * abs(float(wl))
    for k, v in want.params.items():
        assert float((got.params[k] - v).abs().max()) <= 1e-6, k


def test_cross_replica_batchnorm_on_nccl(cuda, nccl_group):
    """RESNET_18_POINTS_PER_WING's moments through the NCCL all-reduce: the
    running averages as the plain step's."""
    from pose_estimation_amitai_torch.models import build_model
    from pose_estimation_amitai_torch.parallel.mesh import make_mesh
    from pose_estimation_amitai_torch.parallel.sharded import make_sharded_train_step, shard_state
    from pose_estimation_amitai_torch.train import loop

    cfg = Config(model_type=C.RESNET_18_POINTS_PER_WING, compute_dtype="float32",
                 do_augmentations=False)
    model = build_model(cfg, (64, 64, 4), 6)
    rng = np.random.default_rng(0)
    data = {"box": torch.from_numpy(rng.random((4, 64, 64, 4), np.float32)).to(cuda),
            "confmaps": torch.from_numpy(rng.random((4, 64, 64, 6), np.float32)).to(cuda)}
    idx = np.arange(4, dtype=np.int32).reshape(1, 4)
    mesh = make_mesh((1,), "cuda")
    state = loop.create_train_state(model, cfg, device=cuda)
    want, _ = loop.make_train_step(model, cfg)(state, data, idx)
    got, _ = make_sharded_train_step(model, cfg, mesh)(
        shard_state(mesh, state), {"image": data["box"][None], "confmaps": data["confmaps"][None]})
    for k, v in want.batch_stats.items():
        assert float((got.batch_stats[k] - v).abs().max()) <= 1e-5 * float(v.abs().max()), k


def test_pipeline_ring_attention_and_moe_on_nccl(cuda, nccl_group):
    """Degree 1 of the pipeline (2 microbatches), the ring and the experts:
    each against its one-process function, forward and gradients."""
    from pose_estimation_amitai_torch.parallel import expert, pipeline, sequence

    gen = torch.Generator(device=cuda).manual_seed(0)
    pipe = pipeline.PipelinedViT(
        pipeline.make_pipeline_mesh(1, 1, "cuda"), image_hw=48, in_channels=4, out_channels=6,
        dim=32, depth=2, heads=2, dim_head=16, mlp_expand=2, num_microbatches=2,
        dtype=torch.float32)
    params = pipe.init(gen)
    x = torch.randn(4, 48, 48, 4, generator=gen, device=cuda)
    outs = []
    for fn in (pipe.apply, pipe.apply_sequential):
        live = {k: v.clone().requires_grad_() for k, v in params.items()}
        y = fn(live, x)
        y.square().sum().backward()
        outs.append((y.detach(), {k: v.grad for k, v in live.items()}))
    (y1, g1), (y2, g2) = outs
    assert float((y1 - y2).abs().max()) <= 1e-4 * float(y2.abs().max())
    for k in g2:
        assert float((g1[k] - g2[k]).abs().max()) <= 1e-4 * float(g2[k].abs().max()), k

    q, k_, v = (torch.randn(2, 32, 2, 8, generator=gen, device=cuda) for _ in range(3))
    ring = sequence.ring_attention(q, k_, v, sequence.make_seq_mesh(1, 1, "cuda"))
    assert float((ring - sequence.reference_attention(q, k_, v)).abs().max()) <= 1e-5

    moe = expert.MoEFeedForward(expert.make_expert_mesh(1, 1, "cuda"), dim=16, hidden_dim=32,
                                num_experts=4)
    p = moe.init(gen)
    t = torch.randn(2, 6, 16, generator=gen, device=cuda)
    assert float((moe.apply(moe.shard_params(p), t) - moe.apply_dense(p, t)).abs().max()) <= 1e-5


def test_mesh_predictor_on_nccl_launches_the_kernels(cuda, nccl_group):
    """Predictor(mesh=, use_fused=True): B1 and B2 launch, peaks as the
    mesh-less fused route's."""
    from pose_estimation_amitai_torch.parallel.mesh import make_mesh

    cfg = Config(num_base_filters=8)
    params = init_basicnet_params(np.random.default_rng(0), 4, 6, filters=8)
    frames = np.random.default_rng(1).random((6, 48, 48, 4)).astype(np.float32)
    want = Predictor(cfg, params, (48, 48, 4), 6, device="cuda", chunk_size=4,
                     use_fused=True)(frames)
    pred = Predictor(cfg, params, (48, 48, 4), 6, device="cuda", chunk_size=4, use_fused=True,
                     mesh=make_mesh((1,), "cuda"))
    b1, b2 = hc.fused_encoder_stage.launches, hd.fused_decoder.launches
    got = pred(frames)
    assert hc.fused_encoder_stage.launches > b1 and hd.fused_decoder.launches > b2
    np.testing.assert_array_equal(got, want)


def test_trainer_main_trains_on_the_card_by_default(cuda, tmp_path, capsys):
    """``train.trainer.main([cfg])`` with no ``--device`` trains a 48-px
    config from an H5 file the port wrote (no h5py on the card's machine):
    its parameters live on the card and its run directory is written."""
    import json
    import os

    from pose_estimation_amitai_torch.data.synthetic import write_synthetic_h5
    from pose_estimation_amitai_torch.train import trainer

    data = write_synthetic_h5(str(tmp_path / "data.h5"), num_frames=4, num_points=8,
                              image_size=48, seed=0)
    cfg = {"model type": "MODEL_18_POINTS_PER_WING", "batch_size": 4, "epochs": 1,
           "batches per epoch": 2, "number of base filters": 8,
           "base output path": str(tmp_path / "runs"), "data_path": data,
           "val_fraction": 0.5, "viz_every": 0}
    cfg_path = str(tmp_path / "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    trainer.main([cfg_path])
    assert "training on cuda:0" in capsys.readouterr().out
    (run,) = os.listdir(tmp_path / "runs")
    files = set(os.listdir(tmp_path / "runs" / run))
    assert {"checkpoint.pt", "best_model.pt", "final_confmaps_model.pt"} <= files, files


def test_jax_run_directory_serves_on_fused(cuda, tmp_path):
    """chip_smoke.py's import phase (a) at filters 16: a JAX run directory
    (best_model.msgpack as flax writes it, by the port's packer) through
    Predictor.from_checkpoint on "fused", B1 and B2 launched, its maps and
    peaks bit-equal to a Predictor of the tree in memory."""
    from pose_estimation_amitai_torch import weights

    params = init_basicnet_params(np.random.default_rng(4), 4, 6, filters=16)
    (tmp_path / "best_model.msgpack").write_bytes(weights.pack_flax_msgpack(params))
    cfg = Config(num_base_filters=16)
    kw = dict(use_fused=True, device="cuda", chunk_size=8, return_heatmaps=True)
    pred = Predictor.from_checkpoint(cfg, str(tmp_path), (48, 48, 4), 6, **kw)
    assert pred.serving_path == "fused"
    frames = np.random.default_rng(5).random((10, 48, 48, 4), dtype=np.float32)
    enc, dec = hc.fused_encoder_stage.launches, hd.fused_decoder.launches
    maps, pts = pred(frames)
    assert (hc.fused_encoder_stage.launches - enc, hd.fused_decoder.launches - dec) == (6, 2)
    want_maps, want_pts = Predictor(cfg, params, (48, 48, 4), 6, **kw)(frames)
    np.testing.assert_array_equal(maps, want_maps)
    np.testing.assert_array_equal(pts, want_pts)


def test_keras_saves_import_and_serve_on_card(cuda, tmp_path):
    """chip_smoke.py's import phase (b) at small widths: keras saves written
    by the port's HDF5 writer and read back name for name and bit for bit;
    the basic_nn on "module", card vs CPU in float32; the ViT through ``cli
    import``, on "fused" from the .h5 (S1 launched) and on "module" from the
    snapshot, within summation order of each other in float32."""
    import chip_smoke

    from pose_estimation_amitai_torch import cli, importers

    rng = np.random.default_rng(6)
    frames = np.random.default_rng(7).random((5, 48, 48, 4), dtype=np.float32)
    cfg = Config(compute_dtype="float32")
    path = str(tmp_path / "basic_nn.h5")
    written = chip_smoke.keras_save(path, chip_smoke.keras_basicnet_layers(rng, 8, 4, 6, 2))
    assert chip_smoke.same_weights(importers._keras_weight_list(path), written)
    got = [Predictor.from_checkpoint(cfg, path, (48, 48, 4), 6, device=d, chunk_size=2,
                                     return_heatmaps=True)(frames)[0] for d in ("cuda", "cpu")]
    np.testing.assert_allclose(got[0], got[1], atol=1e-4 * np.abs(got[1]).max())

    vcfg = Config(model_type=C.MODEL_18_POINTS_PER_WING_VIT, projection_dim=64, num_heads=2,
                  transformer_layers=2, fully_connected_expand=2, compute_dtype="float32")
    vpath, snap = str(tmp_path / "vit.h5"), str(tmp_path / "vit.pt")
    written = chip_smoke.keras_save(vpath, chip_smoke.keras_vit_layers(rng, vcfg, 4, 6, 48))
    assert chip_smoke.same_weights(importers._keras_weight_list(vpath), written)
    assert cli.main(["import", vpath, snap]) == 0
    before = ha.fused_attention.launches
    fused = Predictor.from_checkpoint(vcfg, vpath, (48, 48, 4), 6, device="cuda", chunk_size=2,
                                      return_heatmaps=True, use_fused=True,
                                      import_reference=True)
    assert fused.serving_path == "fused"
    maps = fused(frames)[0]
    assert ha.fused_attention.launches - before == 2 * 3  # depth x chunks
    module = Predictor.from_checkpoint(vcfg, snap, (48, 48, 4), 6, device="cuda", chunk_size=2,
                                       return_heatmaps=True)
    assert module.serving_path == "module"
    np.testing.assert_allclose(maps, module(frames)[0], atol=1e-4 * np.abs(maps).max())


# ---------------------------------------------------------------------------
# the 4-camera disentanglement model on the fused route (views folded into
# B1 and B2, its middle on ftl_fusion)
# ---------------------------------------------------------------------------
def _ftl_predictors(dtype: str, chunk_size: int, filters: int = 64, hw: int = 192, n: int = 5):
    """The module and fused Predictors of one seeded FourCamDisentangled
    (its running averages moved off their initial values) with n samples'
    crop-adjusted cameras, and the samples."""
    from pose_estimation_amitai_torch import weights
    from pose_estimation_amitai_torch.models import build_model
    from pose_estimation_amitai_torch.ops import geometry
    from pose_estimation_amitai_torch.train import loop

    cfg = Config(model_type=C.ALL_CAMS_DISENTANGLED_PER_WING_CNN, num_base_filters=filters,
                 compute_dtype=dtype)
    shape, k = (hw, hw, 16), 72
    model = build_model(cfg, shape, k)
    state = loop.create_train_state(model, cfg, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(6)
    params = weights.state_dict_to_flax(
        {n_: v + 0.05 * torch.randn(v.shape, generator=gen) if v.dim() == 1 else v
         for n_, v in state.params.items()}, model)
    stats = weights.batch_stats_to_flax(
        {n_: 0.5 + torch.rand(v.shape, generator=gen) if n_.endswith("var") else
         torch.randn(v.shape, generator=gen) for n_, v in state.batch_stats.items()})
    rng = np.random.default_rng(1)
    frames = rng.random((n, *shape), dtype=np.float32)
    Ks = torch.tensor([[7500.0, 0, 640], [0, 7500.0, 400], [0, 0, 1]]).expand(4, 3, 3)
    Rs = torch.linalg.qr(torch.randn(4, 3, 3, generator=gen))[0]
    ts = torch.tensor([[0.0], [0.0], [210.0]]).expand(4, 3, 1)
    crops = torch.stack([torch.randint(0, 608, (n, 4), generator=gen),
                         torch.randint(0, 1088, (n, 4), generator=gen)], -1)
    cams = tuple(c.numpy() for c in geometry.crop_adjusted_matrices(Ks, Rs, ts, crops, hw))
    preds = [Predictor(cfg, params, shape, k, device="cuda", chunk_size=chunk_size,
                       return_heatmaps=True, batch_stats=stats, cameras=cams, use_fused=f)
             for f in (False, True)]
    assert [p.serving_path for p in preds] == ["module", "fused"]
    return preds, frames


@pytest.mark.parametrize("dtype, share", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_ftl_fused_matches_module_on_card(cuda, dtype, share):
    """Full width (filters 64, 192 x 192 x 16 -> 72), 5 samples in chunks of
    2: the fused route's maps within ``share`` of the module's largest
    (float32: summation order; bf16: each route rounds its convs, 1x1s and
    sums apart, about 1% of max a layer) and each fused peak where the
    module's map lies within that share of the range below its maximum."""
    (module, fused), frames = _ftl_predictors(dtype, 2)
    (want, _), (got, pts) = module(frames), fused(frames)
    assert got.shape == want.shape == (5, 192, 192, 72)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= share * scale
    flat = want.reshape(5, -1, 72)
    at = np.take_along_axis(flat, (pts[:, 1] * 192 + pts[:, 0]).astype(np.int64)[:, None], 1)
    rng = flat.max(axis=(1, 2)) - flat.min(axis=(1, 2))
    assert ((flat.max(axis=1) - at[:, 0]) <= share * rng[:, None]).all()


def test_ftl_fused_launches_a_chunk(cuda):
    """A chunk of the fused disentanglement model runs B1 three times,
    ftl_fusion once and B2 once, all on the card: 2 chunks, 6 / 2 / 2."""
    from pose_estimation_amitai_torch.ops import ftl_fusion as ff

    (_, fused), frames = _ftl_predictors("bfloat16", 2, filters=16, hw=64, n=4)
    before = (hc.fused_encoder_stage.launches, ff.ftl_fusion.launches,
              hd.fused_decoder.launches)
    fused(frames)
    torch.cuda.synchronize()
    after = (hc.fused_encoder_stage.launches, ff.ftl_fusion.launches,
             hd.fused_decoder.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (6, 2, 2)


def test_ftl_predict_movie_is_pipelined(cuda, monkeypatch):
    """A camera model's predict_movie keeps chunks in flight: at prefetch 4
    four chunks are dispatched before the first is fetched; at prefetch 1,
    2 and 4 the peaks, a ragged tail included, are __call__'s bit for bit."""
    from pose_estimation_amitai_torch import infer

    (_, fused), frames = _ftl_predictors("bfloat16", 2, filters=16, hw=64, n=11)
    fused.return_heatmaps = False
    want = fused(frames)
    order = []
    run, fetched = infer.Predictor._run, infer._fetched
    monkeypatch.setattr(infer.Predictor, "_run",
                        lambda self, *a: (order.append("run"), run(self, *a))[1])
    monkeypatch.setattr(infer, "_fetched", lambda p: (order.append("fetch"), fetched(p))[1])
    for prefetch in (1, 2, 4):
        order.clear()
        np.testing.assert_array_equal(fused.predict_movie(frames, prefetch=prefetch), want)
        assert order[: prefetch + 1] == ["run"] * prefetch + ["fetch"], order
