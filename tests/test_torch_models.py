"""The port's BasicNet (the "module" route) and its fused forward vs the JAX
package on the same bridged weights (f32 on CPU, atol 2e-5), and the
registry's refusals for what this slice does not port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch import weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.models import BasicNet, build_model
from pose_estimation_amitai_torch.models import _NOT_PORTED
from pose_estimation_amitai_torch.models import fast_infer
from pose_estimation_amitai_tpu.models import build_model as jax_build_model
from pose_estimation_amitai_tpu.models.cnn import BasicNet as JaxBasicNet
from pose_estimation_amitai_tpu.models.fast_infer import (
    basicnet_apply_fused as jax_apply_fused,
)


def _flax_net(filters, out_ch=6, seed=0, kernel_size=3):
    model = JaxBasicNet(out_channels=out_ch, filters=filters, dtype=jnp.float32,
                        kernel_size=kernel_size)
    x = np.random.default_rng(seed).random((2, 48, 48, 4)).astype(np.float32)
    params = model.init({"params": jax.random.key(seed)}, jnp.asarray(x),
                        train=False)["params"]
    rng = np.random.default_rng(seed + 100)
    # nonzero biases, so the bridge's bias mapping is exercised
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: np.array(v) + (rng.standard_normal(v.shape) * 0.05).astype(
            np.float32) if p[-1].key == "bias" else np.array(v), params)
    return model, params, x


def _port_net(params, filters, out_ch=6, kernel_size=3):
    net = BasicNet(4, out_ch, filters=filters, kernel_size=kernel_size,
                   dtype=torch.float32)
    net.load_state_dict(weights.basicnet_state_dict(params))
    return net.eval()


@pytest.mark.parametrize("filters", [8, 48])
def test_module_matches_flax_apply(filters):
    model, params, x = _flax_net(filters)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = _port_net(params, filters)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 48, 48, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("kernel_size", [1, 5])
def test_module_matches_flax_apply_at_other_kernel_sizes(kernel_size):
    """The bridge at kernel sizes whose flipped axes are 1 long (a flip that
    numpy keeps as a negative stride) and 5 long."""
    model, params, x = _flax_net(8, kernel_size=kernel_size)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = _port_net(params, 8, kernel_size=kernel_size)(torch.from_numpy(x)).numpy()
    # the reference's fixed crop (padding 1, output_padding 1) at any kernel size
    side = 4 * 12 + 3 * (kernel_size - 3)
    assert got.shape == want.shape == (2, side, side, 6)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_kernel_bridges_copy_whatever_the_strides():
    for shape in [(1, 1, 2, 3), (1, 3, 2, 2), (3, 3, 4, 5)]:
        k = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        d = weights.deconv_kernel_to_torch(k)
        c = weights.conv_kernel_to_torch(k)
        assert d.is_contiguous() and c.is_contiguous()
        np.testing.assert_array_equal(d.numpy(), k[::-1, ::-1].transpose(2, 3, 0, 1))
        np.testing.assert_array_equal(c.numpy(), k.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("filters", [8, 32])  # 32: latent 128, JAX fuses its decoder
def test_fused_forward_matches_jax_fused_and_flax(filters):
    model, params, x = _flax_net(filters, seed=1)
    want_flax = np.asarray(model.apply({"params": params}, jnp.asarray(x), train=False))
    want_fused = np.asarray(jax_apply_fused(model, params, jnp.asarray(x), interpret=True))
    kp = fast_infer.kernel_params(params, torch.float32, "cpu")
    got = fast_infer.basicnet_apply_fused(kp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want_fused, atol=2e-5)
    np.testing.assert_allclose(got, want_flax, atol=2e-5)


def test_bf16_module_close_to_flax_bf16():
    """bf16 compute: the port holds bf16 params, flax casts f32 params to
    bf16 at apply; both round the same weights, so they agree to bf16
    precision of the maps (rounding placement differs per op)."""
    model, params, x = _flax_net(8, seed=2)
    jm = JaxBasicNet(out_channels=6, filters=8, dtype=jnp.bfloat16)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), train=False))
    net = BasicNet(4, 6, filters=8, dtype=torch.bfloat16)
    net.load_state_dict(weights.basicnet_state_dict(params))
    with torch.inference_mode():
        got = net.eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=3e-2 * np.abs(want).max())


def test_state_dict_bridge_covers_the_module():
    _, params, _ = _flax_net(8)
    sd = weights.basicnet_state_dict(params)
    net = BasicNet(4, 6, filters=8, dtype=torch.float32)
    want = net.state_dict()
    assert sd.keys() == want.keys()
    for k in sd:
        assert sd[k].shape == want[k].shape, k


def test_init_basicnet_params_matches_flax_tree():
    model, params, x = _flax_net(8)
    mine = weights.init_basicnet_params(np.random.default_rng(0), 4, 6, 8)
    shapes = jax.tree_util.tree_map(np.shape, params)
    assert jax.tree_util.tree_map(np.shape, mine) == shapes
    model.apply({"params": mine}, jnp.asarray(x), train=False)  # a valid tree


@pytest.mark.parametrize("model_type", [
    C.MODEL_18_POINTS_PER_WING, C.PER_WING_MODEL, C.ALL_POINTS_MODEL,
    C.BODY_PARTS_MODEL, C.HEAD_TAIL_PER_CAM,
])
def test_build_model_basicnet_family(model_type):
    cfg = Config(model_type=model_type, num_base_filters=8)
    assert type(jax_build_model(cfg, (48, 48, 4), 6)).__name__ == "BasicNet"
    net = build_model(cfg, (48, 48, 4), 6)
    assert type(net) is BasicNet and net.dtype == torch.bfloat16
    assert net.filters == 8 and net.out_channels == 6 and net.in_channels == 4


@pytest.mark.parametrize("model_type", sorted(_NOT_PORTED))
def test_build_model_refuses_unported_types(model_type):
    cfg = Config(model_type=model_type)
    assert type(jax_build_model(cfg, (48, 48, 4), 6)).__name__ != "BasicNet"
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 10"):
        build_model(cfg, (48, 48, 4), 6)


def test_tf_flavour_refused():
    with pytest.raises(NotImplementedError, match="Queue A item 2"):
        build_model(Config(arch_flavor="tf"), (48, 48, 4), 6)


def test_training_forward_refused():
    net = BasicNet(4, 6, filters=8, dtype=torch.float32)  # train mode by default
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        net(torch.zeros((1, 16, 16, 4)))
