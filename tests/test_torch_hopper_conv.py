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
