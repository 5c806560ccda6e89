"""The port's ViT modules, ``ViTPoseNet`` and ``ViT4Cameras`` vs flax
``apply`` on shared weights (bridged by ``weights.vit_state_dict``), f32 on
the CPU at atol 1e-4, and bf16 at the JAX test's own limit (rtol 0.05, atol
0.05). Sizes as tests/test_models.py: 48x48x4 frames, dim 64, depth 2,
heads 2, dim_head 64, MLP x2, 6 maps, batch 4. On the CPU the
``fused_attention`` switch runs the attention kernel's plain version."""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch import weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.models import build_model, vit as tvit
from pose_estimation_amitai_torch.models import vit_single_kwargs
from pose_estimation_amitai_tpu.models import build_model as jax_build_model
from pose_estimation_amitai_tpu.models import vit as jvit

ATOL = 1e-4
ARCH = dict(patch_size=16, dim=64, depth=2, heads=2, dim_head=64, mlp_expand=2)


def _init(model, *args, seed=0):
    """flax init, then every bias and LayerNorm scale perturbed, so the
    bridge's mapping of each is exercised."""
    params = model.init({"params": jax.random.key(seed)}, *args)["params"]
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: np.array(v) + (rng.standard_normal(v.shape) * 0.05).astype(
            np.float32) if p[-1].key in ("bias", "scale") else np.array(v), params)


def _load(net: nn.Module, params) -> nn.Module:
    sd = weights.vit_state_dict(params)
    assert sd.keys() == net.state_dict().keys()
    net.load_state_dict(sd)
    return net.eval()


def _run(net, *args):
    with torch.inference_mode():
        return net(*[torch.from_numpy(np.asarray(a)) for a in args]).float().numpy()


def _tokens(seed, b=4, n=9, d=64, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((b, n, d)) * scale).astype(
        np.float32)


def _frames(seed, b=4, size=48, c=4):
    return np.random.default_rng(seed).standard_normal((b, size, size, c)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("core", ["exact", "fast_softmax", "fused_attention",
                                  "fused_serving"])
@pytest.mark.parametrize("tf", [False, True])
def test_attention_matches_flax(core, tf):
    x = _tokens(1)
    jkw = dict(fast_softmax=core in ("fast_softmax", "fused_serving"),
               fused_serving=core == "fused_serving")
    jm = jvit.Attention(64, 2, 32, dtype=jnp.float32, pre_norm=not tf, qkv_bias=tf,
                        **jkw)
    params = _init(jm, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    net = _load(tvit.Attention(64, 2, 32, torch.float32, pre_norm=not tf, qkv_bias=tf,
                               fused_attention=core == "fused_attention", **jkw), params)
    got = _run(net, x)
    assert got.shape == want.shape == (4, 9, 64)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_attention_kernel_switch_excludes_fast_softmax():
    with pytest.raises(ValueError, match="excludes fast_softmax"):
        tvit.Attention(64, 2, 32, fast_softmax=True, fused_attention=True)


@pytest.mark.parametrize("tf", [False, True])
def test_feedforward_matches_flax(tf):
    x = _tokens(2)
    jm = jvit.FeedForward(64, 128, dtype=jnp.float32, pre_norm=not tf,
                          activation="relu" if tf else "gelu")
    params = _init(jm, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    net = _load(tvit.FeedForward(64, 128, torch.float32, pre_norm=not tf,
                                 activation="relu" if tf else "gelu"), params)
    np.testing.assert_allclose(_run(net, x), want, atol=ATOL, rtol=0)


def test_gelu_is_the_tanh_form(monkeypatch):
    """flax ``nn.gelu`` is the tanh approximation; with torch's default
    (erf) the same module misses flax by more than the tolerance."""
    x = _tokens(3, scale=2.0)
    jm = jvit.FeedForward(64, 128, dtype=jnp.float32)
    params = _init(jm, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    net = _load(tvit.FeedForward(64, 128, torch.float32), params)
    np.testing.assert_allclose(_run(net, x), want, atol=ATOL, rtol=0)
    monkeypatch.setattr(tvit, "_gelu", torch.nn.functional.gelu)
    assert np.abs(_run(net, x) - want).max() > 3 * ATOL


def test_layer_norm_epsilon_is_flax(monkeypatch):
    """flax LayerNorm's epsilon is 1e-6; on low-variance tokens torch's
    default 1e-5 misses flax by more than the tolerance."""
    assert tvit.LN_EPS == 1e-6 and nn.LayerNorm(4).eps == 1e-5
    x = _tokens(4, scale=3e-3)  # variance 9e-6, of the epsilons' order
    jm = jvit.FeedForward(64, 128, dtype=jnp.float32)
    params = _init(jm, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    net = _load(tvit.FeedForward(64, 128, torch.float32), params)
    assert net.norm.eps == 1e-6
    np.testing.assert_allclose(_run(net, x), want, atol=ATOL, rtol=0)
    net.norm.eps = 1e-5
    assert np.abs(_run(net, x) - want).max() > 3 * ATOL


@pytest.mark.parametrize("core", ["exact", "fast_softmax", "fused_attention"])
@pytest.mark.parametrize("flavor", ["torch", "tf"])
def test_transformer_matches_flax(flavor, core):
    x = _tokens(5)
    jm = jvit.Transformer(64, 2, 2, 32, 128, dtype=jnp.float32, flavor=flavor,
                          fast_softmax=core == "fast_softmax")
    params = _init(jm, jnp.asarray(x))
    assert ("final_norm" in params) == (flavor == "torch")
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    net = _load(tvit.Transformer(64, 2, 2, 32, 128, torch.float32, flavor,
                                 fast_softmax=core == "fast_softmax",
                                 fused_attention=core == "fused_attention"), params)
    np.testing.assert_allclose(_run(net, x), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("post_norm", [True, False])
def test_patch_embed_matches_flax(post_norm):
    x = _frames(6)
    jm = jvit.PatchEmbed(64, 16, post_norm=post_norm, dtype=jnp.float32)
    params = _init(jm, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    net = _load(tvit.PatchEmbed(4, 9, 64, 16, post_norm, torch.float32), params)
    got = _run(net, x)
    assert got.shape == want.shape == (4, 9, 64)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="square"):
        net(torch.zeros(1, 48, 32, 4))


@pytest.mark.parametrize("flavor, kernel_size", [
    ("torch", 3), ("torch", 4), ("torch", 5),
    ("tf", 2), ("tf", 3), ("tf", 4), ("tf", 5),
])
def test_decoder_deconv_padding_matches_flax(flavor, kernel_size):
    """The torch flavour's ((k-2, k-1), (k-2, k-1)) crop and the tf
    flavour's "SAME" at stride 2, each against flax ConvTranspose."""
    tokens = _tokens(7, b=2, n=9, d=16)
    jm = jvit.CNNDecoderViT(5, 16, kernel_size, flavor, jnp.float32)
    params = _init(jm, jnp.asarray(tokens))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)))
    net = _load(tvit.CNNDecoderViT(5, 16, kernel_size, flavor, torch.float32), params)
    got = _run(net, tokens)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("normalize_output", [True, False])
@pytest.mark.parametrize("ref_token_grid", [False, True])
def test_decoder_switches_match_flax(normalize_output, ref_token_grid):
    tokens = _tokens(8, b=3, n=9, d=16)
    kw = dict(normalize_output=normalize_output, ref_token_grid=ref_token_grid)
    jm = jvit.CNNDecoderViT(5, 16, 3, "torch", jnp.float32, **kw)
    params = _init(jm, jnp.asarray(tokens))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)))
    net = _load(tvit.CNNDecoderViT(5, 16, 3, "torch", torch.float32, **kw), params)
    got = _run(net, tokens)
    assert got.shape == want.shape == (3, 48, 48, 5)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if normalize_output:  # per sample: each spans [0, 1]
        np.testing.assert_allclose(got.min(axis=(1, 2, 3)), 0, atol=1e-6)
        np.testing.assert_allclose(got.max(axis=(1, 2, 3)), 1, atol=1e-6)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def single():
    """flax ViTPoseNet params per flavour, and the frames."""
    x = _frames(9)
    out = {}
    for flavor in ("torch", "tf"):
        jm = jvit.ViTPoseNet(out_channels=6, **ARCH, flavor=flavor, dtype=jnp.float32)
        out[flavor] = (jm, _init(jm, jnp.asarray(x), seed=1))
    return x, out


def _port_single(params, flavor, dtype=torch.float32, **kw):
    return _load(tvit.ViTPoseNet(4, 48, 6, **ARCH, flavor=flavor, dtype=dtype, **kw),
                 params)


@pytest.mark.parametrize("switches", [
    {}, {"normalize_output": False}, {"ref_token_grid": True},
    {"fast_softmax": True}, {"fast_softmax": True, "fused_serving": True},
    {"fast_softmax": True, "normalize_output": False},
], ids=lambda s: "+".join(s) or "default")
@pytest.mark.parametrize("flavor", ["torch", "tf"])
def test_vitposenet_matches_flax(single, flavor, switches):
    x, models = single
    jm, params = models[flavor]
    want = np.asarray(jm.clone(**switches).apply({"params": params}, jnp.asarray(x)))
    got = _run(_port_single(params, flavor, **switches), x)
    assert got.shape == want.shape == (4, 48, 48, 6)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("flavor", ["torch", "tf"])
def test_vitposenet_attention_kernel_switch_matches_flax_exact(single, flavor):
    """fused_attention has no flax switch: it is the exact softmax, so it
    is held against flax's default."""
    x, models = single
    jm, params = models[flavor]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = _run(_port_single(params, flavor, fused_attention=True), x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("switches", [{}, {"fast_softmax": True},
                                      {"fused_attention": True}],
                         ids=lambda s: "+".join(s) or "exact")
def test_vitposenet_bf16_close_to_flax_bf16(single, switches):
    """bf16 compute rounds at other places in XLA and in PyTorch: the JAX
    test's own limit between its bf16 chains (rtol 0.05, atol 0.05)."""
    x, models = single
    jm, params = models["torch"]
    jsw = {k: v for k, v in switches.items() if k != "fused_attention"}
    want = np.asarray(jm.clone(dtype=jnp.bfloat16, normalize_output=False, **jsw).apply(
        {"params": params}, jnp.asarray(x)).astype(jnp.float32))
    got = _run(_port_single(params, "torch", torch.bfloat16, normalize_output=False,
                            **switches), x)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)


@pytest.fixture(scope="module")
def four():
    x = np.random.default_rng(10).random((2, 32, 32, 16)).astype(np.float32)
    kw = dict(out_channels=8, patch_size=16, dim=24, depth=1, heads=2, dim_head=12,
              num_fuse_layers=2)
    jm = jvit.ViT4Cameras(**kw, dtype=jnp.float32)
    return x, kw, jm, _init(jm, jnp.asarray(x))


@pytest.mark.parametrize("switches", [
    {}, {"normalize_output": False}, {"fast_softmax": True},
    {"fast_softmax": True, "fused_serving": True}, {"fused_attention": True},
], ids=lambda s: "+".join(s) or "default")
def test_vit4cameras_folded_equals_unfolded_and_flax(four, switches):
    x, kw, jm, params = four
    jsw = {k: v for k, v in switches.items() if k != "fused_attention"}
    want = np.asarray(jm.clone(**jsw).apply({"params": params}, jnp.asarray(x)))
    outs = [_run(_load(tvit.ViT4Cameras(16, 32, **kw, dtype=torch.float32,
                                        fold_views=fold, **switches), params), x)
            for fold in (True, False)]
    assert outs[0].shape == want.shape == (2, 32, 32, 8)
    # the JAX test's own limit between its two paths (tests/test_models.py
    # test_vit4cam_view_fold_bit_parity); the library's matrix products block
    # by row count, so 4x the rows moves sums in their last bits
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(outs[0], want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# registry, bridge, refusals
# ---------------------------------------------------------------------------
VIT_SINGLE = [C.MODEL_18_POINTS_PER_WING_VIT, C.ALL_POINTS_MODEL_VIT,
              C.MODEL_18_POINTS_3_GOOD_CAMERAS_VIT,
              C.MODEL_18_POINTS_PER_WING_VIT_TO_POINTS]
VIT_4CAM = [C.ALL_CAMS_18_POINTS_VIT, C.ALL_CAMS_VIT, C.VIT_4_CAMERAS]


@pytest.mark.parametrize("model_type", VIT_SINGLE + VIT_4CAM)
@pytest.mark.parametrize("dim_head", [-1, 0])
def test_build_model_vit_families(model_type, dim_head):
    """Same class, and a state_dict that the bridge fills from the flax
    init of the JAX registry's model, key for key and shape for shape."""
    four = model_type in VIT_4CAM
    cfg = Config(model_type=model_type, projection_dim=32, num_heads=2,
                 transformer_layers=1, fully_connected_expand=2, dim_head=dim_head)
    shape, k = ((32, 32, 16), 8) if four else ((32, 32, 4), 6)
    jm = jax_build_model(cfg, shape, k)
    net = build_model(cfg, shape, k)
    assert type(net).__name__ == type(jm).__name__ == (
        "ViT4Cameras" if four else "ViTPoseNet")
    assert net.dtype == torch.bfloat16
    attn = (net.shared_encoder if four else net.transformer).attn0
    assert attn.dim_head == jm.dim_head == (32 if dim_head else 64)
    params = jm.init({"params": jax.random.key(0)}, jnp.zeros((1, *shape)))["params"]
    sd = weights.vit_state_dict(params)
    want = net.state_dict()
    assert sd.keys() == want.keys()
    for name in sd:
        assert sd[name].shape == want[name].shape, name
    # LayerNorms and the positional embedding stay float32 in a bf16 model
    assert want["patch_embed.embed_norm.weight"].dtype == torch.float32
    assert want["patch_embed.pos_embedding"].dtype == torch.float32
    assert want["patch_embed.proj.weight"].dtype == torch.bfloat16


def test_build_model_serving_switches():
    cfg = Config(model_type=C.MODEL_18_POINTS_PER_WING_VIT, projection_dim=32,
                 num_heads=2, transformer_layers=1)
    net = build_model(cfg, (32, 32, 4), 6, fused_attention=True, normalize_output=False)
    assert net.transformer.attn0.fused_attention and not net.decoder.normalize_output
    assert vit_single_kwargs(cfg, 6)["dim_head"] == 32
    with pytest.raises(ValueError, match="single-view ViT"):
        vit_single_kwargs(Config(), 6)
    with pytest.raises(TypeError, match="serving switches"):
        build_model(Config(), (32, 32, 4), 6, fast_softmax=True)
    with pytest.raises(TypeError):  # fold_views is the 4-camera model's
        build_model(cfg, (32, 32, 4), 6, fold_views=False)


@pytest.mark.parametrize("kind", ["torch", "tf", "four"])
def test_init_vit_params_matches_flax_tree(kind):
    rng = np.random.default_rng(0)
    if kind == "four":
        jm = jvit.ViT4Cameras(out_channels=8, patch_size=16, dim=24, depth=1, heads=2,
                              dim_head=12, num_fuse_layers=2, dtype=jnp.float32)
        x = jnp.zeros((1, 32, 32, 16))
        mine = weights.init_vit_params(rng, 16, 8, 32, dim=24, depth=1, heads=2,
                                       dim_head=12, four_cameras=True,
                                       num_fuse_layers=2)
    else:
        jm = jvit.ViTPoseNet(out_channels=6, **ARCH, flavor=kind, dtype=jnp.float32)
        x = jnp.zeros((1, 48, 48, 4))
        mine = weights.init_vit_params(rng, 4, 6, 48, **ARCH, flavor=kind)
    params = jm.init({"params": jax.random.key(0)}, x)["params"]
    assert jax.tree_util.tree_map(np.shape, mine) == jax.tree_util.tree_map(
        np.shape, jax.tree_util.tree_map(np.asarray, params))
    assert np.isfinite(np.asarray(jm.apply({"params": mine}, x))).all()


def test_pipeline_layout_is_queued():
    """The stacked-blocks tree of pipeline training (ROADMAP item 14, now
    ported) bridges to the same ViTPoseNet state_dict as the per-layer
    tree it stacks, leaf for leaf."""
    tree = weights.init_vit_params(np.random.default_rng(0), 4, 6, 48, dim=16, depth=2,
                                   heads=2, dim_head=8, mlp_expand=2)
    stacked = weights.vit_tree_to_pipeline(tree, 2)
    assert set(stacked) == {"embed", "blocks", "final_norm", "decoder"}
    want, got = weights.vit_state_dict(tree), weights.vit_state_dict(stacked)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


def _train_net(cls, **kw):
    kw = dict(dim=16, depth=1, heads=2, dim_head=8, dtype=torch.float32, **kw)
    return (tvit.ViTPoseNet(4, 32, 6, **kw) if cls == "single" else
            tvit.ViT4Cameras(16, 32, 8, num_fuse_layers=1, **kw))  # train mode by default


@pytest.mark.parametrize("cls", ["single", "four"])
def test_training_forward_refused(cls):
    """A training-mode forward with dropout and no generator to draw it
    from is refused; without dropout it needs none."""
    x = torch.zeros((1, 32, 32, 4 if cls == "single" else 16))
    with pytest.raises(ValueError, match="needs a generator"):
        _train_net(cls, dropout=0.25)(x)
    assert torch.isfinite(_train_net(cls)(x)).all()


@pytest.mark.parametrize("cls", ["single", "four"])
def test_training_forward_draws_dropout(cls):
    """A training-mode forward runs and draws its dropout (0.25 here, on
    the attention probabilities and the feed-forward) from the generator:
    the same seed gives the same maps, another seed other maps, and the
    eval forward ignores the generator."""
    net = _train_net(cls, dropout=0.25)
    x = torch.rand((2, 32, 32, 4 if cls == "single" else 16),
                   generator=torch.Generator().manual_seed(0))
    a = net(x, torch.Generator().manual_seed(1))
    assert torch.isfinite(a).all()
    assert torch.equal(a, net(x, torch.Generator().manual_seed(1)))
    assert not torch.equal(a, net(x, torch.Generator().manual_seed(2)))
    net.eval()
    assert torch.equal(net(x), net(x, torch.Generator().manual_seed(3)))
