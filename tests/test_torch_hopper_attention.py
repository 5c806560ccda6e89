"""``fused_attention_plain`` (what ``fused_attention`` runs on CPU tensors)
vs the Pallas attention kernel of ``scripts/exp_fused_attention.py`` in
interpret mode and its ``reference_attention``, on the same seeded inputs.

float32: atol 1e-5 (summation order). bfloat16: max abs 0.02, the script's
own limit (its kernel keeps f32 logits, its reference rounds them to bf16;
the plain version follows the kernel)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_estimation_amitai_torch.ops import hopper_attention as ha

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "exp_fused_attention", os.path.join(ROOT, "scripts", "exp_fused_attention.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _qkv(g, n, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((g, n, d)).astype(np.float32) for _ in range(3)]


def _to_torch(arrs, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _to_jax(arrs, dtype):
    return [jnp.asarray(a, dtype) for a in arrs]


# G not a multiple of 8 (gb = 1 divides any G), a ragged N, both head widths
SHAPES = [(16, 144, 64), (3, 144, 256), (5, 50, 64), (7, 9, 8)]


@pytest.mark.parametrize("g, n, d", SHAPES)
def test_plain_matches_pallas_interpret_f32(script, g, n, d):
    arrs = _qkv(g, n, d, seed=g + n + d)
    gb = 8 if g % 8 == 0 else 1
    want = np.asarray(script.fused_attention(*_to_jax(arrs, jnp.float32), gb=gb,
                                             interpret=True))
    ref = np.asarray(script.reference_attention(*_to_jax(arrs, jnp.float32)))
    got = ha.fused_attention_plain(*_to_torch(arrs, torch.float32)).numpy()
    assert got.shape == want.shape == (g, n, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("g, n, d", SHAPES)
def test_plain_matches_pallas_interpret_bf16(script, g, n, d):
    arrs = _qkv(g, n, d, seed=g * n + d)
    gb = 8 if g % 8 == 0 else 1
    want = np.asarray(script.fused_attention(*_to_jax(arrs, jnp.bfloat16), gb=gb,
                                             interpret=True).astype(jnp.float32))
    ref = np.asarray(script.reference_attention(
        *_to_jax(arrs, jnp.bfloat16)).astype(jnp.float32))
    got = ha.fused_attention_plain(*_to_torch(arrs, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() < 0.02
    assert np.abs(got - ref).max() < 0.02


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_takes_strided_views_and_out(dtype):
    """The module's call: q, k, v sliced out of one (B, N, 3, H, D) tensor,
    the result written through a permuted view of a (B, N, H, D) tensor."""
    b, n, h, d = 2, 10, 3, 8
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(b, n, 3, h, d, generator=gen).to(dtype)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    out = torch.zeros(b, n, h, d, dtype=dtype)
    before = ha.fused_attention.launches
    res = ha.fused_attention(q, k, v, out=out.permute(0, 2, 1, 3))
    assert ha.fused_attention.launches == before  # no kernel on the CPU
    assert res.shape == (b, h, n, d) and res.data_ptr() == out.data_ptr()
    flat = [t.reshape(b * h, n, d) for t in (q, k, v)]
    want = ha.fused_attention_plain(*flat).reshape(b, h, n, d).permute(0, 2, 1, 3)
    assert torch.equal(out, want)
    assert torch.equal(ha.fused_attention(*flat), ha.fused_attention_plain(*flat))


def test_plain_rounds_where_the_kernel_does():
    """Probabilities are rounded to the input dtype after the float32
    division; the second product accumulates in float32."""
    arrs = _to_torch(_qkv(2, 12, 16, seed=3), torch.bfloat16)
    q, k, v = (a.float() for a in arrs)
    p = torch.softmax(q @ k.transpose(1, 2) * 16 ** -0.5, dim=-1)
    want = (p.to(torch.bfloat16).float() @ v).to(torch.bfloat16)
    assert torch.equal(ha.fused_attention_plain(*arrs), want)


def test_wrapper_rejects_bad_rank():
    with pytest.raises(ValueError, match=r"\(G, N, D\)"):
        ha.fused_attention(*[torch.zeros(4, 8)] * 3)


# ---------------------------------------------------------------------------
# the wrapper's choice between the two CUDA kernels: a rule on dtype and shape
# ---------------------------------------------------------------------------
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype, n, d, kernel", [
    (BF16, 144, 256, "mma"),   # the ViT encoder's and the fusion block's cores
    (BF16, 144, 64, "mma"),    # dim head 64
    (BF16, 1, 16, "mma"), (BF16, 7, 16, "mma"), (BF16, 33, 32, "mma"),
    (BF16, 100, 80, "mma"), (BF16, 129, 48, "mma"),
    (F32, 144, 256, "fma"),    # float32: TF32 would break the 1e-4 limit
    (F32, 7, 16, "fma"),
    (BF16, 145, 256, "fma"),   # a tenth 16-row tile: more logits than registers
    (BF16, 300, 40, "fma"), (BF16, 576, 256, "fma"), (BF16, 1056, 8, "fma"),
    (BF16, 100, 72, "fma"),    # D off the k-step of 16
    (BF16, 7, 8, "fma"),
    (BF16, 144, 272, "fma"),   # q, k, v of one g past the 227 KB of a block
])
def test_attention_kernel_rule(dtype, n, d, kernel):
    assert ha.attention_kernel_for(dtype, n, d) == kernel


def test_every_cuda_test_shape_gets_a_kernel():
    """The (g, n, d) cases of tests/test_torch_cuda.py, both dtypes: each is
    within the wrapper's limits and the rule names one of the two kernels."""
    for g, n, d in [(2048, 144, 256), (13, 144, 64), (5, 100, 72), (3, 7, 8), (2, 300, 40)]:
        for dtype in (F32, BF16):
            assert 1 <= n <= ha.MAX_N and d % 8 == 0
            assert ha.attention_kernel_for(dtype, n, d) in ha.KERNEL_CODES
    assert ha.attention_kernel_for(BF16, 144, 256) == "mma"
    assert ha.attention_kernel_for(BF16, 100, 72) == "fma"


def test_attention_shared_memory_budget():
    """q, k, v of one g in bf16, rows padded by 8, N rounded up to 16, and 32
    bytes of barriers: the served shape fits a block's 227 KB with 4,320
    bytes to spare, and the rule sends what does not fit to the other
    kernel."""
    assert ha.attention_mma_smem_bytes(144, 256) == 3 * 144 * 264 * 2 + 32 == 228128
    assert ha.attention_mma_smem_bytes(129, 256) == 228128  # 9 tiles either way
    assert ha.attention_mma_smem_bytes(1, 16) == 3 * 16 * 24 * 2 + 32
    assert ha.SMEM_MAX == 227 * 1024
    assert ha.attention_mma_smem_bytes(144, 256) <= ha.SMEM_MAX
    assert ha.attention_mma_smem_bytes(144, 272) > ha.SMEM_MAX
    for n in range(1, ha.MMA_MAX_N + 1):
        for d in range(16, 257, 16):
            assert ha.attention_kernel_for(BF16, n, d) == "mma"
            assert ha.attention_mma_smem_bytes(n, d) <= ha.SMEM_MAX
    # 72 f32 logit registers and 64 f32 output registers a thread: 9 tiles of
    # 16 keys x 2 n-tiles x 4, and a half of D = 256 as 16 n-tiles x 4
    assert ha.MMA_MAX_N // 16 * 2 * 4 == 72 and 128 // 8 * 4 == 64


def test_cpu_calls_leave_the_kernel_counters_alone():
    before = dict(ha.fused_attention.launches_by_kernel), ha.fused_attention.launches
    q = torch.randn(2, 16, 16).bfloat16()
    ha.fused_attention(q, q, q)
    assert (dict(ha.fused_attention.launches_by_kernel),
            ha.fused_attention.launches) == before
    assert set(ha.fused_attention.launches_by_kernel) == set(ha.KERNEL_CODES)


def test_naming_a_kernel_needs_a_cuda_tensor():
    """``fused_attention_on`` launches or raises: a CPU tensor never reaches
    a kernel, and it has no plain path."""
    q = torch.randn(2, 16, 16).bfloat16()
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ha.fused_attention_on("fma", q, q, q)
