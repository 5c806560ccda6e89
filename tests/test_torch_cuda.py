"""The port's hand-written CUDA kernels vs their plain versions, on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false. This file imports only torch and the port (no jax), so it runs on a
machine without the JAX package, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Shapes here are deliberately ragged (sizes off the kernels' 8 x 16 x 64
tiles, channel counts off the 8-channel staging chunk) to reach every
masked edge; chip_smoke.py covers the flagship shapes.
"""

import numpy as np
import pytest
import torch

from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.infer import Predictor
from pose_estimation_amitai_torch.ops import hopper_conv as hc
from pose_estimation_amitai_torch.ops import hopper_deconv as hd
from pose_estimation_amitai_torch.weights import init_basicnet_params

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
