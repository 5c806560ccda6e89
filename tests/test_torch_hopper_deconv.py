"""Fused decoder (B2): the port's plain version vs the Pallas kernel in
interpret mode (f32, atol 2e-5, as tests/test_pallas_deconv.py) and, at a
latent width the Pallas kernel refuses, vs flax ``DecoderUp``; the rule that
names each stride-2 layer's kernel, and the tap table both kernels follow,
multiplied out in plain PyTorch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_estimation_amitai_torch.ops import hopper_deconv as hd
from pose_estimation_amitai_tpu.models.layers import DecoderUp
from pose_estimation_amitai_tpu.ops.pallas_deconv import fused_decoder


def _decoder_args(params):
    return [np.array(params[f"deconv{i}"][k])
            for i in (1, 2, 3, 4) for k in ("kernel", "bias")]


def _flax_decoder(lat, out_ch, seed=0):
    dec = DecoderUp(out_ch, filters=8, dtype=jnp.float32)
    params = dec.init(jax.random.key(seed), jnp.asarray(lat))["params"]
    # nonzero biases, so the bias path is exercised
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + rng.standard_normal(v.shape).astype(np.float32) * 0.05
        if p[-1].key == "bias" else v, params)
    return dec, params


@pytest.mark.parametrize("out_ch", [6, 18])
def test_decoder_matches_pallas_interpret(out_ch):
    lat = np.random.default_rng(0).random((2, 12, 12, 128)).astype(np.float32)
    _, params = _flax_decoder(lat, out_ch)
    args = _decoder_args(params)
    want = np.asarray(fused_decoder(jnp.asarray(lat), *args, interpret=True))
    targs = [torch.from_numpy(lat)] + [torch.from_numpy(a) for a in args]
    plain = hd.fused_decoder_plain(*targs).numpy()
    wrapped = hd.fused_decoder(*targs).numpy()  # CPU -> plain
    assert plain.shape == want.shape == (2, 48, 48, out_ch)
    np.testing.assert_allclose(plain, want, atol=2e-5)
    np.testing.assert_array_equal(wrapped, plain)


@pytest.mark.parametrize("cin", [64, 96])
def test_decoder_any_latent_width_matches_flax(cin):
    """Latent widths the Pallas kernel refuses (cin % 128 != 0)."""
    lat = np.random.default_rng(1).random((2, 10, 14, cin)).astype(np.float32)
    dec, params = _flax_decoder(lat, 18, seed=1)
    with pytest.raises(AssertionError):
        fused_decoder(jnp.asarray(lat), *_decoder_args(params), interpret=True)
    want = np.asarray(dec.apply({"params": params}, jnp.asarray(lat)))
    got = hd.fused_decoder(
        torch.from_numpy(lat), *(torch.from_numpy(a) for a in _decoder_args(params))
    ).numpy()
    assert got.shape == want.shape == (2, 40, 56, 18)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_wrapper_refuses_non_cpu_non_cuda_tensors():
    lat = torch.empty((1, 4, 4, 16), device="meta")
    w = torch.empty((3, 3, 16, 8), device="meta")
    b = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        hd.fused_decoder(lat, w, b, w, b, w, b, w, b)


@pytest.mark.parametrize("dtype, cin, cout, kernel", [
    (torch.bfloat16, 256, 128, "mma"),  # the served first layer
    (torch.bfloat16, 128, 18, "mma"),   # the served head: any K
    (torch.bfloat16, 16, 1, "mma"),
    (torch.bfloat16, 48, 5, "mma"),
    (torch.bfloat16, 128, 70, "mma"),
    (torch.bfloat16, 24, 18, "fma"),    # Cin off the 16-channel chunks
    (torch.bfloat16, 9, 24, "fma"),
    (torch.bfloat16, 8, 8, "fma"),
    (torch.float32, 256, 128, "fma"),   # TF32 would break the 1e-4 limit
    (torch.float32, 128, 18, "fma"),
    (torch.float16, 128, 18, "fma"),
])
def test_up2_kernel_for(dtype, cin, cout, kernel):
    assert hd.up2_kernel_for(dtype, cin, cout) == kernel


def test_up2_mma_shared_memory_is_the_ring():
    """Three stages of the 9 x 17 patch (32 bytes a pixel) and the 9 x 16 x
    32 bf16 weight slab, and the patch table: under the 48 KB that need no
    opt-in, and more than the bf16 output tile laid over it."""
    ring = 3 * (9 * 17 * 32 + 9 * 16 * 32 * 2) + 4 * 9 * 17
    assert hd.up2_mma_smem_bytes() == ring == 42948
    assert 2 * 16 * 32 * 40 <= ring <= 48 * 1024 <= hd.SMEM_MAX


@pytest.mark.parametrize("conv_kernel, up2_kernels, message", [
    ("mma", ("fma", "fma"), "does not take"),        # float32 convs stay on fma
    ("fma", ("mma", "fma"), "stride-2 kernel 'mma'"),
    ("fma", ("fma", "mma"), "stride-2 kernel 'mma'"),
    ("fma", ("fma", "wgmma"), "stride-2 kernel 'wgmma'"),
])
def test_decoder_on_refuses_a_kernel_the_rule_does_not_allow(conv_kernel, up2_kernels,
                                                             message):
    """Checked from dtype and shape before any CUDA call, so also here."""
    lat = torch.zeros((1, 4, 4, 32))
    args = []
    for ci, co in ((32, 16), (16, 16), (16, 16), (16, 6)):
        args += [torch.zeros((3, 3, ci, co)), torch.zeros((co,))]
    with pytest.raises(ValueError, match=message):
        hd.fused_decoder_on(conv_kernel, up2_kernels, lat, *args)
    with pytest.raises(ValueError, match="2"):  # one name a layer
        hd.fused_decoder_on("fma", ("fma",), lat, *args)
    # the names the rule gives pass that check and reach the device check
    with pytest.raises(ValueError, match="CUDA"):
        hd.fused_decoder_on("fma", ("fma", "fma"), lat, *args)


def test_tap_table_is_the_stride2_layer():
    """Per axis y[2j] = x[j] W[1], y[2j+1] = x[j] W[0] + x[j+1] W[2]: the nine
    taps fall 4, 2, 2 and 1 on the four neighbours and 1, 2, 2 and 4 on the
    four phases."""
    assert hd.UP2_TAP_SHIFT == (0, 0, 1) and hd.UP2_TAP_PARITY == (1, 0, 1)
    taps = [(ky, kx) for ky in range(3) for kx in range(3)]
    by_neighbour, by_phase = {}, {}
    for ky, kx in taps:
        n = (hd.UP2_TAP_SHIFT[ky], hd.UP2_TAP_SHIFT[kx])
        ph = (hd.UP2_TAP_PARITY[ky], hd.UP2_TAP_PARITY[kx])
        by_neighbour[n] = by_neighbour.get(n, 0) + 1
        by_phase[ph] = by_phase.get(ph, 0) + 1
    assert by_neighbour == {(0, 0): 4, (0, 1): 2, (1, 0): 2, (1, 1): 1}
    assert by_phase == {(0, 0): 1, (0, 1): 2, (1, 0): 2, (1, 1): 4}


@pytest.mark.parametrize("k", [5, 6, 18])
@pytest.mark.parametrize("b, r, wd, cin", [(2, 7, 9, 16), (1, 13, 10, 48), (3, 1, 1, 5)])
def test_polyphase_products_match_conv_transpose(k, b, r, wd, cin):
    """The four phase products the kernels compute, from the tap table, vs
    the library's transposed convolution (f32, atol 2e-5)."""
    rng = np.random.default_rng(k * cin + r)
    x = torch.from_numpy(rng.standard_normal((b, cin, r, wd)).astype(np.float32))
    w = torch.from_numpy(
        (rng.standard_normal((3, 3, cin, k)) / np.sqrt(9 * cin)).astype(np.float32))
    got = hd.up2_polyphase_plain(x, w)
    want = hd._up2(x, w)
    assert got.shape == want.shape == (b, k, 2 * r, 2 * wd)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def test_decoder_counters_exist_and_count_nothing_on_the_cpu():
    before = (hd.fused_decoder.launches, dict(hd.fused_decoder.up2_by_kernel),
              dict(hd.fused_decoder.convs_by_kernel))
    lat = torch.zeros((1, 4, 4, 32))
    args = []
    for ci, co in ((32, 16), (16, 16), (16, 16), (16, 6)):
        args += [torch.zeros((3, 3, ci, co)), torch.zeros((co,))]
    assert hd.fused_decoder(lat, *args).shape == (1, 16, 16, 6)
    assert set(hd.fused_decoder.up2_by_kernel) == {"fma", "mma"}
    assert before == (hd.fused_decoder.launches, hd.fused_decoder.up2_by_kernel,
                      hd.fused_decoder.convs_by_kernel)
