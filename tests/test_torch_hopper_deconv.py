"""Fused decoder (B2): the port's plain version vs the Pallas kernel in
interpret mode (f32, atol 2e-5, as tests/test_pallas_deconv.py) and, at a
latent width the Pallas kernel refuses, vs flax ``DecoderUp``."""

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
