"""Fused encoder stage (B1): the port's plain version vs the Pallas kernel in
interpret mode and vs flax ``EncoderAtrous`` (f32, atol 1e-5, as
tests/test_pallas_conv.py). On CPU tensors the wrapper is the plain
version; the CUDA kernel itself is held against it in
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_estimation_amitai_torch.ops import hopper_conv as hc
from pose_estimation_amitai_tpu.models.layers import EncoderAtrous
from pose_estimation_amitai_tpu.ops.pallas_conv import fused_encoder_stage
from pose_estimation_amitai_torch.models.fast_infer import encoder_stage_params

KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


def _stage_weights(rng, cin, cout):
    out = {}
    for i, c in ((1, cin), (2, cout), (3, cout)):
        out[f"w{i}"] = (rng.standard_normal((3, 3, c, cout))
                        / np.sqrt(9 * c)).astype(np.float32)
        out[f"b{i}"] = (rng.standard_normal(cout) * 0.05).astype(np.float32)
    return out


@pytest.mark.parametrize("filters", [8, 48])
@pytest.mark.parametrize("pool", [True, False])
def test_stage_matches_pallas_interpret(filters, pool):
    rng = np.random.default_rng(filters)
    x = rng.random((2, 48, 48, 4)).astype(np.float32)
    w = _stage_weights(rng, 4, filters)
    want = np.asarray(fused_encoder_stage(
        jnp.asarray(x), *(jnp.asarray(w[k]) for k in KEYS),
        pool=pool, interpret=True,
    ))
    args = [torch.from_numpy(x)] + [torch.from_numpy(w[k]) for k in KEYS]
    plain = hc.fused_encoder_stage_plain(*args, pool=pool).numpy()
    wrapped = hc.fused_encoder_stage(*args, pool=pool).numpy()  # CPU -> plain
    assert plain.shape == want.shape
    np.testing.assert_allclose(plain, want, atol=1e-5)
    np.testing.assert_array_equal(wrapped, plain)


@pytest.mark.parametrize("filters", [8, 48])
def test_encoder_matches_flax(filters):
    """Three chained stages (pool after 1 and 2) == flax EncoderAtrous, on
    flax's own init as tests/test_pallas_conv.py uses."""
    x = np.random.default_rng(10 + filters).random((2, 48, 48, 4)).astype(
        np.float32)
    enc = EncoderAtrous(filters=filters, dtype=jnp.float32)
    params = {"encoder": jax.tree_util.tree_map(np.array, enc.init(
        {"params": jax.random.key(0)}, jnp.asarray(x), train=False)["params"])}
    want = np.asarray(enc.apply(
        {"params": params["encoder"]}, jnp.asarray(x), train=False,
    ))
    stages = [{k: torch.from_numpy(v) for k, v in s.items()}
              for s in encoder_stage_params(params)]
    got = hc.encoder_forward_fused(torch.from_numpy(x), stages).numpy()
    assert got.shape == want.shape == (2, 12, 12, 4 * filters)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_plain_rounds_intermediates_to_input_dtype():
    """bf16 stage: x1/x2 are stored in bf16 as the TPU kernel's scratch is,
    and the result differs from an all-f32 chain by bf16 rounding only."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((1, 16, 16, 4)).astype(np.float32))
    w = {k: torch.from_numpy(v) for k, v in _stage_weights(rng, 4, 8).items()}
    f32 = hc.fused_encoder_stage_plain(x, *(w[k] for k in KEYS))
    bf = hc.fused_encoder_stage_plain(
        x.bfloat16(), *(w[k].bfloat16() if k[0] == "w" else w[k] for k in KEYS))
    assert bf.dtype == torch.bfloat16 and bf.shape == f32.shape
    err = (bf.float() - f32).abs().max().item()
    assert 0 < err <= 2e-2 * f32.abs().max().item()


def test_wrapper_refuses_non_cpu_non_cuda_tensors():
    """Only CPU tensors take the plain version: any other device must reach
    the kernel checks (and here, with no CUDA, raise) — never fall back."""
    x = torch.empty((1, 8, 8, 4), device="meta")
    w = torch.empty((3, 3, 4, 8), device="meta")
    b = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        hc.fused_encoder_stage(x, w, b, w, b, w, b)


# ---------------------------------------------------------------------------
# the wrapper's choice between the conv kernels, their shared-memory budget,
# and the implicit GEMM the tensor-core kernels perform, multiplied out
# ---------------------------------------------------------------------------
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype, cin, cout, dil, kernel", [
    (BF16, 4, 64, 2, "mma_c4"),     # the encoder's first conv
    (BF16, 64, 64, 2, "wgmma"), (BF16, 64, 128, 2, "wgmma"), (BF16, 128, 128, 2, "wgmma"),
    (BF16, 128, 256, 2, "wgmma"), (BF16, 256, 256, 2, "wgmma"),
    (BF16, 128, 128, 1, "wgmma"),   # the decoder's two stride-1 convs
    (BF16, 16, 8, 8, "wgmma"), (BF16, 4, 8, 8, "mma_c4"), (BF16, 32, 72, 1, "wgmma"),
    (BF16, 64, 64, 1, "wgmma"), (BF16, 64, 64, 8, "wgmma"),    # N = 64 tiles, both ends
    (BF16, 128, 256, 1, "wgmma"), (BF16, 256, 256, 8, "wgmma"),  # N = 128, one patch slot
    (BF16, 16, 72, 8, "wgmma"), (BF16, 48, 136, 5, "wgmma"),   # ragged Cout, Cin off 64
    (F32, 4, 64, 2, "fma"), (F32, 64, 64, 2, "fma"), (F32, 128, 128, 1, "fma"),
    (BF16, 3, 24, 2, "fma"), (BF16, 9, 70, 1, "fma"), (BF16, 5, 8, 2, "fma"),
    (BF16, 24, 24, 2, "fma"),       # Cin off the multiple of 16
    (BF16, 8, 8, 2, "fma"),
    (BF16, 16, 130, 3, "fma"), (BF16, 130, 130, 3, "fma"), (BF16, 70, 70, 1, "fma"),
    (BF16, 4, 70, 2, "fma"),        # Cout off the 16-byte store
    (BF16, 64, 64, 9, "fma"),       # past the widest halo
])
def test_conv_kernel_rule(dtype, cin, cout, dil, kernel):
    assert hc.conv_kernel_for(dtype, cin, cout, dil) == kernel


def test_every_cuda_test_stage_gets_kernels():
    """The ragged stages of tests/test_torch_cuda.py: each of their three
    convs gets an answer, in both dtypes, and none of them in float32 or off
    the channel multiples takes a tensor-core kernel."""
    for cin, cout, dil in [(3, 24, 2), (9, 70, 1), (16, 130, 3), (5, 8, 2)]:
        for dtype in (F32, BF16):
            kernels = [hc.conv_kernel_for(dtype, c, cout, dil) for c in (cin, cout, cout)]
            assert set(kernels) <= set(hc.CONV_KERNEL_CODES)
            if dtype == F32 or cout % 8:
                assert kernels == ["fma"] * 3
    # flagship: the first conv on the packed kernel, the 8 other convs of the
    # three stages and the decoder's 2 stride-1 convs on the wgmma kernel
    kernels = []
    for cin, cout in [(4, 64), (64, 128), (128, 256)]:
        kernels += [hc.conv_kernel_for(BF16, c, cout, 2) for c in (cin, cout, cout)]
    kernels += [hc.conv_kernel_for(BF16, 128, 128, 1)] * 2
    assert kernels == ["mma_c4"] + ["wgmma"] * 10


def test_conv_shared_memory_budget():
    """The wgmma kernel's rings fit at every dilation the rule gives it
    (csrc/conv_mma.cuh checks that when it compiles): at the widest halo,
    dilation 8, one patch slot of 32 x 32 pixels of 64 bf16 channels, two
    64 x 128 bf16 weight slots, 1 KB to align and 256 bytes of barriers stay
    within SMEM_MAX; the rule takes dilations 1..MAX_DILATION and no more.
    The packed first conv's f32 epilogue tile."""
    side = 16 + 2 * hc.MAX_DILATION
    patch, weights = side * side * 2 * hc.WGMMA_CIN, 128 * hc.WGMMA_CIN * 2
    assert 1280 + patch + 2 * weights == 165120 <= hc.SMEM_MAX
    assert [hc.conv_kernel_for(BF16, 64, cout, dil)
            for dil in range(1, hc.MAX_DILATION + 2) for cout in (64, 128)] == (
        ["wgmma"] * 2 * hc.MAX_DILATION + ["fma"] * 2)
    assert hc.conv_c4_smem_bytes() == 4 * 256 * 72 == 73728
    assert 2 * (256 * 56 + 48 * 72) == 35584 < 73728  # the packed staging itself
    # 64 f32 accumulators a thread of the packed kernel: 2 m16 tiles x 8 n8 tiles x 4
    assert 2 * (hc.MMA_COUT // 8) * 4 == 64


def _implicit_gemm_conv(x, w, dil):
    """SAME 3x3 dilated conv of NHWC ``x`` with HWIO ``w`` as the wgmma
    kernel multiplies it out: zero padding at staging (TMA's fill), a tap as
    a pixel offset into the padded patch, K = 9 taps x Cin walked in chunks
    of 64 input channels (zero past Cin; taps inside a chunk), f32 sums."""
    b, h, wd, cin = x.shape
    chunks = -(-cin // hc.WGMMA_CIN)
    patch = torch.nn.functional.pad(
        x, (0, chunks * hc.WGMMA_CIN - cin, dil, dil, dil, dil))
    wpad = torch.nn.functional.pad(w, (0, 0, 0, chunks * hc.WGMMA_CIN - cin))
    acc = torch.zeros(b, h, wd, w.shape[-1])
    for c0 in range(0, chunks * hc.WGMMA_CIN, hc.WGMMA_CIN):
        for ky in range(3):
            for kx in range(3):
                a = patch[:, ky * dil:ky * dil + h, kx * dil:kx * dil + wd,
                          c0:c0 + hc.WGMMA_CIN]                     # A: pixels x 64
                acc += a @ wpad[ky, kx, c0:c0 + hc.WGMMA_CIN]       # B: 64 x Cout
    return acc


def _packed_c4_conv(x, w, dil):
    """The same for Cin = 4: the nine taps of a pixel packed into one row of
    K = 48 (columns 36.. zero), times the HWIO kernel read as it lies as a
    (36, Cout) matrix, zero rows below."""
    b, h, wd, cin = x.shape
    assert cin == 4
    patch = torch.nn.functional.pad(x, (0, 0, dil, dil, dil, dil))
    rows = torch.zeros(b, h, wd, hc.MMA_C4_K)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        rows[..., tap * 4:tap * 4 + 4] = patch[:, ky * dil:ky * dil + h,
                                               kx * dil:kx * dil + wd]
    slab = torch.zeros(hc.MMA_C4_K, w.shape[-1])
    slab[:36] = w.reshape(36, -1)
    return rows @ slab


@pytest.mark.parametrize("cin, cout, dil, pool", [(4, 16, 2, True), (16, 32, 1, False),
                                                  (4, 16, 3, False), (32, 16, 2, True)])
def test_implicit_gemm_equals_plain_and_pallas(cin, cout, dil, pool):
    """The stage assembled from the two GEMM forms (with the kernels'
    epilogue: bias, LReLU, skip, NaN-propagating pool, LReLU) equals
    ``fused_encoder_stage_plain`` and, at the shapes the Pallas kernel takes,
    the Pallas kernel in interpret mode, in float32 within 1e-5."""
    rng = np.random.default_rng(cin * cout + dil)
    x = rng.random((2, 18, 20, cin)).astype(np.float32)
    w = _stage_weights(rng, cin, cout)
    t = {k: torch.from_numpy(v) for k, v in w.items()}

    def conv(inp, wk):
        form = {"mma_c4": _packed_c4_conv, "wgmma": _implicit_gemm_conv}[
            hc.conv_kernel_for(BF16, inp.shape[-1], cout, dil)]
        return form(inp, wk, dil)

    xt = torch.from_numpy(x)
    x1 = hc.lrelu(conv(xt, t["w1"]) + t["b1"], 0.1)
    x2 = hc.lrelu(conv(x1, t["w2"]) + t["b2"], 0.1) + x1
    y = hc.lrelu(conv(x2, t["w3"]) + t["b3"], 0.1) + x2
    if pool:
        q = y.reshape(2, 9, 2, 10, 2, cout)
        y = hc.lrelu(q.amax(dim=(2, 4)), 0.1)
    plain = hc.fused_encoder_stage_plain(xt, *(t[k] for k in KEYS), dilation=dil, pool=pool)
    np.testing.assert_allclose(y.numpy(), plain.numpy(), atol=1e-5)
    if dil == 2 and cin == 4:
        xj = rng.random((2, 48, 48, 4)).astype(np.float32)
        want = np.asarray(fused_encoder_stage(
            jnp.asarray(xj), *(jnp.asarray(w[k]) for k in KEYS), pool=pool, interpret=True))
        xt = torch.from_numpy(xj)
        x1 = hc.lrelu(conv(xt, t["w1"]) + t["b1"], 0.1)
        x2 = hc.lrelu(conv(x1, t["w2"]) + t["b2"], 0.1) + x1
        y = hc.lrelu(conv(x2, t["w3"]) + t["b3"], 0.1) + x2
        y = hc.lrelu(y.reshape(2, 24, 2, 24, 2, cout).amax(dim=(2, 4)), 0.1)
        np.testing.assert_allclose(y.numpy(), want, atol=1e-5)


def test_cpu_calls_leave_the_kernel_counters_alone():
    before = dict(hc.fused_encoder_stage.convs_by_kernel), hc.fused_encoder_stage.launches
    x = torch.rand(1, 8, 8, 4)
    w = {k: torch.from_numpy(v) for k, v in _stage_weights(np.random.default_rng(0), 4, 8).items()}
    hc.fused_encoder_stage(x, *(w[k] for k in KEYS))
    assert (dict(hc.fused_encoder_stage.convs_by_kernel),
            hc.fused_encoder_stage.launches) == before
    assert set(hc.fused_encoder_stage.convs_by_kernel) == set(hc.CONV_KERNEL_CODES)


def test_naming_a_kernel_needs_a_cuda_tensor():
    """``fused_encoder_stage_on`` launches or raises: a CPU tensor never
    reaches a kernel, and it has no plain path."""
    x = torch.rand(1, 8, 8, 4)
    w = {k: torch.from_numpy(v) for k, v in _stage_weights(np.random.default_rng(0), 4, 8).items()}
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        hc.fused_encoder_stage_on(("fma",) * 3, x, *(w[k] for k in KEYS))
