"""Int8 stage (B3) and single int8 conv (S2): the port's plain versions vs
the Pallas kernel in interpret mode and vs XLA's int8 conv, and the exact
int8 conv primitives vs integer references. On CPU tensors the wrappers are
the plain versions; the CUDA kernels are held against them in
tests/test_torch_cuda.py and chip_smoke.py.

The JAX side is compiled with ``xla_allow_excess_precision=False``. By
default XLA on the CPU drops ``f32 -> bf16 -> f32`` round trips inside a
fused computation, so the requant ``bf16(v) * bf16(inv)`` is evaluated from
the unrounded ``v``; that moves 8-27% of a stage's int8 outputs by up to two
quanta from what the same jnp ops give one by one. With the option off the
compiled kernel rounds where the source says, and the port equals it bit
for bit. Nothing in the JAX package changes for that.

One float step remains the compiler's: in one case below XLA contracts
conv1's ``f32(acc) * m1 + b1`` into a fused multiply-add (one rounding where
the source and the port have two; modelling it in float64 reproduces the JAX
output exactly). That case is held to at most one quantum on at most 0.1% of
the elements (22 of 147,456 differ); every other case is equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from pose_estimation_amitai_torch.ops import hopper_qconv as hq
from pose_estimation_amitai_torch.ops import int8_conv
from pose_estimation_amitai_tpu.ops.pallas_qconv import fused_quantized_stage

DN = ("NHWC", "HWIO", "NHWC")


def strict(fn, *args):
    """``fn(*args)`` jitted with bf16 roundings kept where the source has
    them."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _stage_inputs(rng, b, h, w, cin, cout):
    """Random int8 frames and weights with dequant multipliers that bring
    each conv's output to unit scale, and requant multipliers of 20-40."""
    x = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    layers = []
    for c in (cin, cout, cout):
        layers += [
            rng.integers(-127, 128, (3, 3, c, cout)).astype(np.int8),
            (rng.uniform(0.5, 1.5, cout) / (np.sqrt(9 * c) * 5329)).astype(np.float32),
            (rng.standard_normal(cout) * 0.05).astype(np.float32),
        ]
    return x, layers, [float(v) for v in rng.uniform(20, 40, 3)]


# 46 x 50 runs the Pallas kernel as one row tile: its tiles shorter than the
# 3 * dilation halo read rows outside the frame, and 46 only divides by 2
@pytest.mark.parametrize("cin, cout, h, w, dilation, pool, row_tile, exact", [
    (4, 8, 48, 48, 2, True, 16, True),
    (4, 8, 48, 48, 2, False, 16, True),
    (32, 32, 46, 50, 1, True, 46, True),
    (32, 32, 46, 50, 2, False, 46, True),
    (4, 32, 48, 48, 1, False, 16, False),  # XLA fuses conv1's multiply-add
    (32, 8, 48, 48, 2, True, 16, True),
])
def test_stage_matches_pallas_interpret(cin, cout, h, w, dilation, pool, row_tile, exact):
    rng = np.random.default_rng(cin * cout + h)
    x, layers, invs = _stage_inputs(rng, 2, h, w, cin, cout)
    want = np.asarray(strict(
        lambda x, *a: fused_quantized_stage(
            x, *a, *invs, dilation=dilation, pool=pool, row_tile=row_tile,
            interpret=True),
        jnp.asarray(x), *map(jnp.asarray, layers)))
    args = [torch.from_numpy(x)] + [torch.from_numpy(a) for a in layers]
    plain = hq.fused_quantized_stage_plain(*args, *invs, dilation=dilation, pool=pool)
    wrapped = hq.fused_quantized_stage(*args, *invs, dilation=dilation, pool=pool)
    assert plain.dtype == torch.int8 and plain.shape == want.shape == (2, h, w, cout)
    assert plain.is_contiguous()
    assert 10 < np.abs(want).mean() < 64  # the int8 range is used, unsaturated
    if exact:
        np.testing.assert_array_equal(plain.numpy(), want)
    else:
        diff = np.abs(plain.numpy().astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy())  # CPU -> plain


@pytest.mark.parametrize("b, h, w, cin, cout, dilation", [
    (2, 24, 40, 64, 64, 2),  # the experiment's channels and dilation
    (1, 17, 19, 5, 7, 1),
    (2, 16, 16, 12, 70, 3),
])
def test_conv3x3_matches_xla_int8_conv(b, h, w, cin, cout, dilation):
    """The single conv vs the experiment's XLA twin, rebuilt here from
    ``lax.conv_general_dilated`` on its seeded value ranges."""
    rng = np.random.default_rng(h + cin)
    wq = rng.integers(-90, 90, (3, 3, cin, cout)).astype(np.int8)
    mult = (rng.uniform(5e-4, 2e-3, cout) * 64 / cin).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
    x = rng.integers(-80, 80, (b, h, w, cin)).astype(np.int8)

    def xla_conv(x, w, mult, bias, alpha=0.1, inv_out=64.0):
        y = lax.conv_general_dilated(
            x, w, (1, 1), "SAME", rhs_dilation=(dilation, dilation),
            dimension_numbers=DN, preferred_element_type=jnp.int32,
        ).astype(jnp.float32) * mult + bias
        y = jnp.where(y >= 0, y, y * alpha)
        return jnp.clip(jnp.round(y * inv_out), -127, 127).astype(jnp.int8)

    want = np.asarray(jax.jit(xla_conv)(*map(jnp.asarray, (x, wq, mult, bias))))
    args = [torch.from_numpy(a) for a in (x, wq, mult, bias)]
    plain = hq.quantized_conv3x3_plain(*args, dilation=dilation)
    assert plain.dtype == torch.int8 and plain.is_contiguous()
    assert np.abs(want).max() == 127 and np.abs(want).mean() > 10
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(
        hq.quantized_conv3x3(*args, dilation=dilation).numpy(), plain.numpy())


def test_conv_s32_is_exact_beyond_float32():
    """All-127 inputs over 256 channels: interior sums are 9 * 256 * 127**2
    = 37,161,216 > 2**24, odd multiples that float32 cannot hold."""
    x = torch.full((1, 6, 7, 256), 127, dtype=torch.int8)
    w = torch.full((3, 3, 256, 3), 127, dtype=torch.int8)
    w[..., 1] = -127
    w[1, 1, 0, 2] = 126  # an odd total: 37,161,216 - 127
    got = int8_conv.conv_s32(x, w, dilation=2).numpy()
    xp = np.pad(x.numpy().astype(np.int64), ((0, 0), (2, 2), (2, 2), (0, 0)))
    want = np.zeros((1, 6, 7, 3), np.int64)
    for ky in range(3):
        for kx in range(3):
            want += xp[:, 2 * ky : 2 * ky + 6, 2 * kx : 2 * kx + 7] @ w[ky, kx].numpy().astype(np.int64)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert want.max() == 9 * 256 * 127 ** 2 and want[0, 2, 2, 2] == want.max() - 127
    assert float(np.float32(want[0, 2, 2, 2])) != want[0, 2, 2, 2]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["conv_d2", "deconv_s1", "deconv_s2"])
def test_int8_primitives_match_lax_int32(name):
    """The three conv forms of the int8 forwards vs lax with
    ``preferred_element_type=int32``, on an odd-sized input."""
    rng = np.random.default_rng(5)
    x = rng.integers(-127, 128, (2, 9, 11, 12)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 12, 10)).astype(np.int8)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    if name == "conv_d2":
        want = lax.conv_general_dilated(
            jx, jw, (1, 1), "SAME", rhs_dilation=(2, 2), dimension_numbers=DN,
            preferred_element_type=jnp.int32)
        got = int8_conv.conv_s32(tx, tw, 2)
    elif name == "deconv_s1":
        want = lax.conv_general_dilated(
            jx, jw, (1, 1), "SAME", dimension_numbers=DN,
            preferred_element_type=jnp.int32)
        got = int8_conv.deconv_s1_s32(tx, tw)
    else:
        want = lax.conv_general_dilated(
            jx, jw, (1, 1), [(1, 2), (1, 2)], lhs_dilation=(2, 2),
            dimension_numbers=DN, preferred_element_type=jnp.int32)
        got = int8_conv.deconv_s2_s32(tx, tw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_max_pool_2x2_on_int8():
    x = torch.from_numpy(np.random.default_rng(2).integers(
        -127, 128, (2, 6, 8, 5)).astype(np.int8))
    got = int8_conv.max_pool_2x2(x)
    want = torch.nn.functional.max_pool2d(
        x.permute(0, 3, 1, 2).float(), 2, 2).permute(0, 2, 3, 1)
    assert got.dtype == torch.int8 and got.shape == (2, 3, 4, 5)
    np.testing.assert_array_equal(got.float().numpy(), want.numpy())


def test_quant_bf16_rounds_to_bf16_then_to_even():
    """bf16(v) * bf16(inv) rounded to bf16, then rint: 2.5 -> 2, 3.5 -> 4;
    1.00390625 rounds to bf16 1.0 first; values clip at +-127."""
    v = torch.tensor([2.5, 3.5, -2.5, 1.00390625, 1000.0, -1000.0, 0.3])
    got = hq.quant_bf16(v, 1.0).tolist()
    assert got == [2, 4, -2, 1, 127, -127, 0]
    # inv is rounded to bf16 too: 3.0078125 -> 3.0, so 0.5 * inv = 1.5 -> 2
    assert hq.quant_bf16(torch.tensor([0.5]), 3.0078125).tolist() == [2]
    want = np.asarray(jnp.bfloat16(1.0 / 0.0123)).astype(np.float32)
    assert hq.bf16_round(1.0 / 0.0123) == float(want)


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Only CPU tensors take the plain version: any other device must reach
    the kernel checks (and here, with no CUDA, raise) — never fall back."""
    x = torch.empty((1, 8, 8, 4), dtype=torch.int8, device="meta")
    w = torch.empty((3, 3, 4, 8), dtype=torch.int8, device="meta")
    v = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        hq.fused_quantized_stage(x, w, v, v, w, v, v, w, v, v, 1.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        hq.quantized_conv3x3(x, w, v, v)
