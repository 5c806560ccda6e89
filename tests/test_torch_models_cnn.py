"""The port's CNN family against flax ``apply`` on the CPU: the tf flavour
and even kernels of ``BasicNet``, ``CoarsePerWing``, ``C2FPerWing``,
``TwoWingsNet``, ``MultiCamNet`` (both flavours, 4 and 3 cameras, the
attention fusion) and ``LatentSelfAttention``; float32 at (2, 48, 48, C)
frames and filters 8, atol 2e-5, and bf16 within 3% of the maps' max.

Each case takes the flax params tree of the JAX registry's model (its
``init`` traced with ``jax.eval_shape``), fills it from a seeded numpy
generator (fan-in scaled kernels, nonzero biases), bridges it with
``weights.flax_to_state_dict`` into the port's model and holds the two
forwards together; then the other way, the port's own seeded parameters
(``create_train_state``) through ``weights.state_dict_to_flax`` into flax
``apply``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch import weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.models import (
    BasicNet, C2FPerWing, CoarsePerWing, LatentSelfAttention, MultiCamNet,
    TwoWingsNet, build_model,
)
from pose_estimation_amitai_torch.train import loop
from pose_estimation_amitai_tpu.config import Config as JConfig
from pose_estimation_amitai_tpu.models import build_model as jbuild_model
from pose_estimation_amitai_tpu.models.multicam import (
    LatentSelfAttention as JLatentSelfAttention,
)

HW = 48
ATOL = 2e-5
BF16_RTOL = 3e-2  # of max|flax maps|, the module route's rule

# (model_type, in_channels, out_channels, flavor, kernel_size, extra config)
CASES = [
    (C.MODEL_18_POINTS_PER_WING, 4, 6, "torch", 4, {}),
    (C.MODEL_18_POINTS_PER_WING, 4, 6, "tf", 3, {}),
    (C.MODEL_18_POINTS_PER_WING, 4, 6, "tf", 2, {}),
    (C.MODEL_18_POINTS_PER_WING, 4, 6, "tf", 3, {"num_blocks": 3}),
    (C.COARSE_PER_WING, 4, 7, "tf", 3, {}),
    (C.COARSE_PER_WING, 4, 7, "tf", 4, {}),
    (C.C2F_PER_WING, 4, 6, "tf", 3, {}),
    (C.C2F_PER_WING, 4, 6, "tf", 4, {}),
    (C.C2F_PER_WING, 4, 6, "torch", 3, {}),
    (C.TWO_WINGS_TOGATHER, 5, 8, "tf", 3, {}),
    (C.TWO_WINGS_TOGATHER, 5, 8, "tf", 2, {}),
    (C.TWO_WINGS_TOGATHER, 5, 8, "torch", 3, {}),
    (C.ALL_CAMS_18_POINTS, 16, 12, "torch", 3, {}),
    (C.ALL_CAMS_18_POINTS, 16, 12, "tf", 3, {}),
    (C.ALL_CAMS_18_POINTS, 16, 12, "tf", 4, {"do_attention": True}),
    (C.HEAD_TAIL_ALL_CAMS, 16, 8, "tf", 2, {}),
    (C.ALL_CAMS_AND_3_GOOD_CAMS, 12, 9, "torch", 3, {}),
    (C.ALL_CAMS_AND_3_GOOD_CAMS, 12, 9, "tf", 4, {"do_attention": True}),
]
IDS = [f"{mt}-{fl}-k{k}" + "".join(f"-{n}{v}" for n, v in e.items())
       for mt, _, _, fl, k, e in CASES]


def _cfg_kw(mt, flavor, kernel_size, extra, dtype="float32"):
    return dict(model_type=mt, num_base_filters=8, arch_flavor=flavor,
                kernel_size=kernel_size, compute_dtype=dtype, **extra)


def _seeded_tree(shapes, seed):
    """Flax-layout values for the tree of shapes: kernels normal over the
    fan-in of their contracting dims, biases normal of std 0.05."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [p.key for p in path]
        if names[-1] != "kernel":
            return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)
        fan = s.shape[0] if names[-2] in ("query", "key", "value") else int(
            np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _with_biases(params, seed=0):
    """flax-initialised parameters (zero biases) with the biases drawn
    normal of std 0.05, so the bias path is seen."""
    gen = torch.Generator().manual_seed(seed)
    return {n: v + 0.05 * torch.randn(v.shape, generator=gen) if n.endswith("bias") else v
            for n, v in params.items()}


def _frames(cin, seed=0, n=2):
    return np.random.default_rng(seed).random((n, HW, HW, cin)).astype(np.float32)


def _flax(mt, cin, kout, flavor, k, extra, dtype="float32"):
    jm = jbuild_model(JConfig(**_cfg_kw(mt, flavor, k, extra, dtype)), (HW, HW, cin), kout)
    x = jnp.zeros((2, HW, HW, cin), jnp.float32)
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.key(0)}, x, train=False))["params"]
    return shapes, jax.jit(lambda p, x: jm.apply({"params": p}, x, train=False))


def _port(mt, cin, kout, flavor, k, extra, dtype="float32"):
    return build_model(Config(**_cfg_kw(mt, flavor, k, extra, dtype)), (HW, HW, cin), kout)


def _forward(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("mt, cin, kout, flavor, k, extra", CASES, ids=IDS)
def test_model_matches_flax_apply_both_ways(mt, cin, kout, flavor, k, extra):
    shapes, apply = _flax(mt, cin, kout, flavor, k, extra)
    params = _seeded_tree(shapes, seed=1)
    x = _frames(cin)
    want = np.asarray(apply(params, jnp.asarray(x)))
    model = _port(mt, cin, kout, flavor, k, extra)
    model.load_state_dict(weights.flax_to_state_dict(params, model))
    got = _forward(model, x)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)

    # the port's own parameters, carried to flax, serve as in the port
    state = loop.create_train_state(model, Config(**_cfg_kw(mt, flavor, k, extra)),
                                    seed=3, device="cpu")
    own = _with_biases(state.params)
    tree = weights.state_dict_to_flax(own, model)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda s: 0, shapes))
    back = weights.flax_to_state_dict(tree, model)
    assert all(torch.equal(back[n], own[n]) for n in own)
    want = np.asarray(apply(tree, jnp.asarray(x)))
    got = loop.make_predict_fn(model)(own, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


BF16 = (6, 9, 12, 14)  # C2F, TwoWingsNet, MultiCamNet torch and tf + attention


@pytest.mark.parametrize("case", [CASES[i] for i in BF16], ids=[IDS[i] for i in BF16])
def test_bf16_model_close_to_flax_bf16(case):
    mt, cin, kout, flavor, k, extra = case
    shapes, apply = _flax(mt, cin, kout, flavor, k, extra, dtype="bfloat16")
    params = _seeded_tree(shapes, seed=2)
    x = _frames(cin, seed=1)
    want = np.asarray(apply(params, jnp.asarray(x)))
    model = _port(mt, cin, kout, flavor, k, extra, dtype="bfloat16")
    model.load_state_dict(weights.flax_to_state_dict(params, model))
    got = _forward(model, x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=BF16_RTOL * np.abs(want).max())


@pytest.mark.parametrize("flavor, attention", [("torch", False), ("tf", False), ("tf", True)])
@pytest.mark.parametrize("num_cams", [4, 3])
def test_multicam_folded_equals_unfolded(flavor, attention, num_cams):
    """JAX's bound (tests/test_models.py::test_multicam_view_fold_bit_parity).
    oneDNN blocks a conv by its batch size, so on this CPU a transposed conv
    of 8 samples differs from four of 2 by about 1e-5: the forwards run on
    the library's batch-invariant native convs, which leave the fold's own
    arithmetic to be seen."""
    kw = dict(filters=8, flavor=flavor, do_attention=attention, dtype=torch.float32,
              num_cams=num_cams)
    folded = MultiCamNet(4 * num_cams, 2 * num_cams, **kw)
    state = loop.create_train_state(folded, Config(), seed=num_cams, device="cpu")
    folded.load_state_dict(_with_biases(state.params))
    unfolded = MultiCamNet(4 * num_cams, 2 * num_cams, fold_views=False, **kw)
    unfolded.load_state_dict(folded.state_dict())
    x = _frames(4 * num_cams, seed=2)
    with torch.backends.mkldnn.flags(enabled=False):
        np.testing.assert_allclose(_forward(folded, x), _forward(unfolded, x),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype, atol", [("float32", 2e-6), ("bfloat16", 3e-2)])
def test_latent_self_attention_matches_flax_mha(dtype, atol):
    jm = JLatentSelfAttention(num_heads=2, key_dim=8, dtype=getattr(jnp, dtype))
    x = np.random.default_rng(3).standard_normal((2, 6, 5, 16)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))["params"]
    params = _seeded_tree(shapes, seed=4)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)).astype(jnp.float32))
    net = LatentSelfAttention(16, num_heads=2, key_dim=8, dtype=getattr(torch, dtype))
    net.load_state_dict(weights.flax_to_state_dict(params, net))
    assert net.mha.query.weight.shape == (16, 2, 8) and net.mha.out.weight.shape == (2, 8, 16)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2).to(net.mha.dtype))
    got = got.permute(0, 2, 3, 1).float().numpy()
    np.testing.assert_allclose(got, want, atol=atol * max(1.0, np.abs(want).max()))


# the JAX registry's contract (tests/test_models.py::test_model_output_contract)
CONTRACT = [(C.TWO_WINGS_TOGATHER, 5, 8, TwoWingsNet), (C.ALL_CAMS_18_POINTS, 16, 12, MultiCamNet),
            (C.HEAD_TAIL_ALL_CAMS, 16, 8, MultiCamNet),
            (C.ALL_CAMS_AND_3_GOOD_CAMS, 12, 9, MultiCamNet),
            (C.COARSE_PER_WING, 4, 7, CoarsePerWing), (C.C2F_PER_WING, 4, 9, C2FPerWing)]


@pytest.mark.parametrize("flavor", ["torch", "tf"])
@pytest.mark.parametrize("mt, cin, kout, cls", CONTRACT, ids=[c[0] for c in CONTRACT])
def test_model_output_contract(mt, cin, kout, cls, flavor):
    cfg = Config(model_type=mt, arch_flavor=flavor, num_base_filters=8)
    model = build_model(cfg, (HW, HW, cin), kout)
    assert type(model) is cls
    assert type(jbuild_model(JConfig(model_type=mt), (HW, HW, cin), kout)).__name__ == cls.__name__
    out = _forward(model, np.zeros((2, HW, HW, cin), np.float32))
    assert out.shape == (2, HW, HW, kout) and out.dtype == np.float32
    assert np.isfinite(out).all()


def test_registry_threads_the_cnn_kwargs():
    cfg = Config(model_type=C.ALL_CAMS_AND_3_GOOD_CAMS, arch_flavor="tf", num_blocks=3,
                 do_attention=True, num_base_filters=8, dropout_ratio=0.25)
    m = build_model(cfg, (HW, HW, 12), 9)
    assert m.num_cams == 3 and m.do_attention and m.shared_encoder.num_blocks == 3
    assert m.shared_encoder.dropout == 0.25 and m.dtype == torch.bfloat16
    coarse = build_model(Config(model_type=C.COARSE_PER_WING, num_blocks=5), (HW, HW, 4), 7)
    assert coarse.flavor == "tf" and coarse.encoder.num_blocks == 3  # forced, as JAX
    c2f = build_model(Config(model_type=C.C2F_PER_WING), (HW, HW, 4), 9)
    assert c2f.coarse.out_channels == 9 and c2f.fine.in_channels == 13
    assert build_model(Config(model_type=C.ALL_CAMS), (HW, HW, 16), 8, fold_views=False).fold_views is False
    with pytest.raises(TypeError, match="serving switches"):
        build_model(Config(model_type=C.TWO_WINGS_TOGATHER), (HW, HW, 5), 8, fold_views=False)
    # the disentangled types take the CNN kwargs as JAX's FourCamDisentangled
    for mt in (C.ALL_CAMS_DISENTANGLED_PER_WING_CNN, C.ALL_CAMS_DISENTANGLED_PER_WING_VIT):
        dis = build_model(cfg.replace(model_type=mt), (HW, HW, 16), 8)
        assert type(dis).__name__ == "FourCamDisentangled" and dis.dtype == torch.bfloat16
        assert dis.shared_encoder.flavor == "tf" and dis.shared_encoder.num_blocks == 3
        assert dis.shared_encoder.dropout == 0.25 and dis.out_channels == 8
        assert dis.rearrange1.out_channels == 300 and dis.fusion1.in_channels == 1600


def test_bridge_names_unknown_and_missing_keys():
    model = BasicNet(4, 6, filters=8, flavor="tf", dtype=torch.float32)
    shapes, _ = _flax(C.MODEL_18_POINTS_PER_WING, 4, 6, "tf", 3, {})
    params = _seeded_tree(shapes, seed=0)
    del params["decoder"]["head_deconv"]
    params["encoder"]["extra_conv"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match=r"missing decoder\.head_deconv\.bias.*"
                                         r"unknown encoder\.extra_conv\.bias"):
        weights.flax_to_state_dict(params, model)
    sd = model.state_dict()
    sd["encoder.block0_conv1.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match=r"encoder\.block0_conv1\.weight: \(1,\)"):
        weights.state_dict_to_flax(sd, model)
    with pytest.raises(ValueError, match="arch_flavor='keras'"):
        BasicNet(4, 6, flavor="keras")
