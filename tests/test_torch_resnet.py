"""The port's BatchNorm families against flax on the CPU: ``ResNetHeatmapNet``
(flavours ``tpu``, ``torch`` and ``tf``), ``GPTResNet``, their pieces
(flax's BatchNorm, stride-2 ``"SAME"`` pads, the cubic resize of
``jax.image.resize``) and the weight bridge's choice of transposed convs by
module type (C4).

Models run at (2, 48, 48, 4) frames with ``stage_sizes=(1, 1, 1, 1)`` (set
on both modules), where stage 3 goes from 3 rows to 2, the odd case in which
the ``tpu`` and ``torch`` flavours pad differently; one case at 192 px and
one forward at the default depth (3, 4, 6, 3). float32 within atol 2e-5,
both directions of the bridge, ``batch_stats`` included; bf16 within 3% of
the maps' max. Flax variables come from ``jax.eval_shape`` of ``init`` and
seeded numpy values (BatchNorm scales near 1, means near 0, variances in
[0.5, 1.5]); the other way, the port's ``create_train_state`` with drawn
biases and averages. Running averages after a training-mode forward are
held to flax's mutated ``batch_stats`` within 1e-6 of each tensor's
largest value (float32 sums in another order)."""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
from flax import linen as fnn

from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch import weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.models import GPTResNet, ResNetHeatmapNet, build_model
from pose_estimation_amitai_torch.models.layers import Deconv, conv, same_pads
from pose_estimation_amitai_torch.models.norm import BatchNorm, collect_batch_stats
from pose_estimation_amitai_torch.models.resnet import cubic_resize
from pose_estimation_amitai_torch.train import loop
from pose_estimation_amitai_tpu.config import Config as JConfig
from pose_estimation_amitai_tpu.models import build_model as jbuild_model
from pose_estimation_amitai_tpu.models.resnet import GPTResNet as JGPTResNet
from pose_estimation_amitai_tpu.models.resnet import ResNetHeatmapNet as JResNetHeatmapNet

ATOL = 2e-5
BF16_RTOL = 3e-2  # of max|flax maps|
STATS_RTOL = 1e-6  # of each running-average tensor's largest value
SMALL = (1, 1, 1, 1)
K = 6


@pytest.fixture
def one_thread():
    """One intra-op thread for the test, restored after. The parallel test
    run puts several workers on the same cores, and eight threads a worker
    on these small shapes then spend their time waiting on each other: a
    case of 5 s alone took 160 s beside five busy processes, and 5 s on one
    thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _one_thread_here(one_thread):
    """Every case of this file on one thread."""


def seeded_variables(shapes, seed):
    """Values for a flax variables tree of shapes: kernels normal over their
    fan-in, biases normal of std 0.05, BatchNorm scales 1 + N(0, 0.1),
    means N(0, 0.1), variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(
                np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "mean":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def own_variables(model, seed):
    """The port's seeded parameters and initial averages with biases,
    BatchNorm scales and averages drawn, so every path is seen."""
    state = loop.create_train_state(model, Config(), seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)

    def draw(name, v):
        if name.endswith("running_var"):
            return 0.5 + torch.rand(v.shape, generator=gen)
        if name.endswith(("bias", "running_mean")):
            return v + 0.05 * torch.randn(v.shape, generator=gen)
        if v.dim() == 1:  # BatchNorm scale
            return v + 0.1 * torch.randn(v.shape, generator=gen)
        return v

    return ({n: draw(n, v) for n, v in state.params.items()},
            {n: draw(n, v) for n, v in state.batch_stats.items()})


def frames(n=2, hw=48, cin=4, seed=0):
    return np.random.default_rng(seed).random((n, hw, hw, cin)).astype(np.float32)


def flax_apply(jm, x):
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.key(0)}, jnp.asarray(x), train=False))
    apply = jax.jit(lambda p, s, x: jm.apply({"params": p, "batch_stats": s}, x, train=False))
    return shapes, apply


def forward(model, x, *rest):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x), *rest).numpy()


def check_both_ways(jm, model, x, atol=ATOL):
    """flax variables bridged into the port, and the port's own bridged
    into flax: the same maps either way."""
    shapes, apply = flax_apply(jm, x)
    variables = seeded_variables(shapes, seed=1)
    want = np.asarray(apply(variables["params"], variables["batch_stats"], jnp.asarray(x)))
    model.load_state_dict(weights.flax_to_state_dict(
        variables["params"], model, variables["batch_stats"]))
    got = forward(model, x)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol)

    params, stats = own_variables(model, seed=3)
    tree, stats_tree = weights.state_dict_to_flax(params, model), weights.batch_stats_to_flax(stats)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda s: 0, shapes["params"]))
    assert jax.tree_util.tree_structure(stats_tree) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda s: 0, shapes["batch_stats"]))
    back = weights.flax_to_state_dict(tree, model, stats_tree)
    assert all(torch.equal(back[n], v) for n, v in {**params, **stats}.items())
    want = np.asarray(apply(tree, stats_tree, jnp.asarray(x)))
    got = loop.make_predict_fn(model)(params, torch.from_numpy(x), batch_stats=stats).numpy()
    np.testing.assert_allclose(got, want, atol=atol)


def check_training_stats(jm, model, x, *rest):
    """Running averages after one training-mode forward: the port's
    collected ones against flax's mutated ``batch_stats``."""
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0)},
                                            *map(jnp.asarray, (x, *rest)), train=False))
    variables = seeded_variables(shapes, seed=4)
    _, mutated = jax.jit(lambda v, *a: jm.apply(
        v, *a, train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)}))(
            variables, *map(jnp.asarray, (x, *rest)))
    want = weights.flax_to_state_dict({}, None, jax.tree_util.tree_map(
        np.asarray, mutated["batch_stats"]))
    model.load_state_dict(weights.flax_to_state_dict(
        variables["params"], model, variables["batch_stats"]))
    names = {m: n for n, m in model.named_modules()}
    model.train()
    with torch.no_grad(), collect_batch_stats() as updates:
        model(*map(torch.from_numpy, (x, *rest)))
    got = {}
    for m, (mean, var) in updates.items():
        got[f"{names[m]}.running_mean"], got[f"{names[m]}.running_var"] = mean, var
    assert set(got) == set(want) and want
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=STATS_RTOL * np.abs(w).max(), err_msg=name)
    # the module itself is left as it was
    assert all(torch.equal(b, model.state_dict()[n]) for n, b in
               weights.flax_to_state_dict({}, None, variables["batch_stats"]).items())


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size, k, stride, dilation", [
    (192, 7, 2, 1), (96, 3, 2, 1), (48, 3, 2, 1), (3, 3, 2, 1), (25, 1, 2, 1),
    (24, 7, 2, 1), (13, 3, 1, 2), (6, 4, 1, 1), (5, 3, 3, 1),
])
def test_same_pads_equal_lax(size, k, stride, dilation):
    window = (k - 1) * dilation + 1
    assert same_pads(size, k, stride, dilation) == tuple(
        jax.lax.padtype_to_pads((size,), (window,), (stride,), "SAME")[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_equals_flax_train_and_eval(dtype):
    """Two training-mode applications of one module (the shared ``bn3``
    case), then the eval forward on the updated averages; float32 out."""
    rng = np.random.default_rng(5)
    x1, x2 = (rng.standard_normal((2, 6, 6, 5)).astype(np.float32) * 3 + 1 for _ in range(2))

    class Twice(fnn.Module):
        @fnn.compact
        def __call__(self, a, b, train):
            bn = fnn.BatchNorm(use_running_average=not train, dtype=jnp.float32, name="bn")
            return bn(a), bn(b)

    jt = getattr(jnp, dtype)
    ja, jb = jnp.asarray(x1).astype(jt), jnp.asarray(x2).astype(jt)
    variables = Twice().init(jax.random.key(0), ja, jb, train=False)
    init = jax.tree_util.tree_map(np.asarray, variables)
    assert np.all(init["params"]["bn"]["scale"] == 1) and not init["params"]["bn"]["bias"].any()
    assert not init["batch_stats"]["bn"]["mean"].any()
    assert np.all(init["batch_stats"]["bn"]["var"] == 1)
    variables = {"params": {"bn": {"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(5),
                                                        jnp.float32),
                                   "bias": jnp.asarray(0.1 * rng.standard_normal(5),
                                                       jnp.float32)}},
                 "batch_stats": variables["batch_stats"]}
    (ya, yb), mutated = Twice().apply(variables, ja, jb, train=True, mutable=["batch_stats"])
    (ea, _) = Twice().apply({**variables, **mutated}, ja, jb, train=False)

    bn = BatchNorm(5)
    assert bn.running_mean.dtype == torch.float32 and not bn.running_mean.any()
    bn.load_state_dict(weights.flax_to_state_dict(
        variables["params"]["bn"], bn, jax.tree_util.tree_map(np.asarray,
                                                              variables["batch_stats"]["bn"])))
    td = getattr(torch, dtype)
    ta, tb = (torch.from_numpy(v).permute(0, 3, 1, 2).to(td) for v in (x1, x2))
    bn.train()
    with torch.no_grad():
        got_a, got_b = bn(ta), bn(tb)  # outside a collector: the buffers move
    assert got_a.dtype == torch.float32
    for got, want in ((got_a, ya), (got_b, yb)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)
    for buf, leaf in (("running_mean", "mean"), ("running_var", "var")):
        w = np.asarray(mutated["batch_stats"]["bn"][leaf])
        np.testing.assert_allclose(getattr(bn, buf).numpy(), w, rtol=0,
                                   atol=STATS_RTOL * np.abs(w).max())
    bn.eval()
    with torch.no_grad():
        np.testing.assert_allclose(bn(ta).permute(0, 2, 3, 1).numpy(), np.asarray(ea),
                                   atol=1e-5)


@pytest.mark.parametrize("shape, size", [
    ((2, 24, 24, 3), (48, 48)), ((1, 96, 96, 2), (192, 192)), ((2, 13, 7, 3), (48, 40)),
])
def test_cubic_resize_equals_jax_image_resize(shape, size):
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0], *size, shape[3]),
                                       method="cubic"))
    got = cubic_resize(torch.from_numpy(x).permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # not torch's bicubic, which clamps at the border with a = -0.75
    torch_bicubic = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=size, mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(torch_bicubic - want).max() > 1e-3


class _Up(nn.Module):
    """A transposed conv by another name than ``deconv``."""

    def __init__(self):
        super().__init__()
        self.up1 = Deconv(6, 6, 2, 2, (1, 1), torch.float32)

    def forward(self, x):
        return conv(self.up1, x)


class _JUp(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.ConvTranspose(6, (2, 2), strides=(2, 2), padding="VALID", name="up1")(x)


def test_bridge_tells_transposed_convs_by_module_type():
    """C4: a 6 -> 6 channel 2x2 transposed conv named ``up1`` has equal OIHW
    and IOHW shapes, so a bridge that laid out only ``deconv`` paths as
    transposed convs passed the key check with the kernel transposed and
    not flipped. With the model, its module type decides."""
    x = np.random.default_rng(7).standard_normal((2, 5, 5, 6)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, _JUp().init(jax.random.key(0), jnp.asarray(x)))
    params["params"]["up1"]["bias"] = np.full(6, 0.1, np.float32)
    want = np.asarray(_JUp().apply(params, jnp.asarray(x)))
    model = _Up()
    sd = weights.flax_to_state_dict(params["params"], model)
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    back = weights.state_dict_to_flax(sd, model)
    np.testing.assert_array_equal(back["up1"]["kernel"], params["params"]["up1"]["kernel"])
    # without a model the name decides, as it did
    assert not torch.equal(weights.flax_to_state_dict(params["params"])["up1.weight"],
                           sd["up1.weight"])


# ---------------------------------------------------------------------------
# the models against flax
# ---------------------------------------------------------------------------
def _resnet(flavor, stage_sizes=SMALL, dtype="float32", stem=64, k=3):
    jm = JResNetHeatmapNet(out_channels=K, kernel_size=k, flavor=flavor, stem_features=stem,
                           stage_sizes=stage_sizes, dtype=getattr(jnp, dtype))
    tm = ResNetHeatmapNet(4, K, kernel_size=k, flavor=flavor, stem_features=stem,
                          stage_sizes=stage_sizes, dtype=getattr(torch, dtype))
    return jm, tm


@pytest.mark.parametrize("flavor, stem, k", [("tpu", 64, 3), ("torch", 64, 3), ("tf", 16, 3),
                                             ("tpu", 64, 4)])
def test_resnet_heatmap_net_matches_flax_both_ways(flavor, stem, k):
    jm, tm = _resnet(flavor, stem=stem, k=k)
    check_both_ways(jm, tm, frames())


def test_resnet_heatmap_net_at_192_px():
    jm, tm = _resnet("tpu")
    check_both_ways(jm, tm, frames(n=1, hw=192))


def test_resnet_heatmap_net_at_the_default_depth():
    jm, tm = _resnet("torch", stage_sizes=(3, 4, 6, 3))
    assert len([n for n in tm.encoder._modules if n.startswith("stage")]) == 16
    x = frames(n=1)
    shapes, apply = flax_apply(jm, x)
    variables = seeded_variables(shapes, seed=2)
    tm.load_state_dict(weights.flax_to_state_dict(
        variables["params"], tm, variables["batch_stats"]))
    np.testing.assert_allclose(
        forward(tm, x), np.asarray(apply(variables["params"], variables["batch_stats"],
                                         jnp.asarray(x))), atol=ATOL)


def test_gpt_resnet_matches_flax_both_ways():
    tm = GPTResNet(4, K, dtype=torch.float32)
    assert isinstance(tm.up1, nn.ConvTranspose2d) and tm.up1.weight.shape == (64, 64, 2, 2)
    check_both_ways(JGPTResNet(out_channels=K, dtype=jnp.float32), tm, frames())


@pytest.mark.parametrize("which", ["resnet-tpu", "resnet-tf", "gpt"])
def test_bf16_close_to_flax_bf16(which):
    if which == "gpt":
        jm, tm = JGPTResNet(out_channels=K, dtype=jnp.bfloat16), GPTResNet(4, K)
    else:
        jm, tm = _resnet(which.split("-")[1], dtype="bfloat16", stem=16)
    x = frames(seed=1)
    shapes, apply = flax_apply(jm, x)
    variables = seeded_variables(shapes, seed=2)
    want = np.asarray(apply(variables["params"], variables["batch_stats"], jnp.asarray(x)))
    tm.load_state_dict(weights.flax_to_state_dict(
        variables["params"], tm, variables["batch_stats"]))
    assert all(m.weight.dtype == m.running_var.dtype == torch.float32
               for m in tm.modules() if isinstance(m, BatchNorm))
    got = forward(tm, x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=BF16_RTOL * np.abs(want).max())


@pytest.mark.parametrize("which", ["resnet-tpu", "resnet-tf", "gpt"])
def test_training_forward_updates_the_averages_as_flax(which):
    if which == "gpt":
        jm, tm = JGPTResNet(out_channels=K, dtype=jnp.float32), GPTResNet(4, K, dtype=torch.float32)
    else:
        jm, tm = _resnet(which.split("-")[1], stem=16)
    check_training_stats(jm, tm, frames(seed=2))


def test_registry_builds_the_families():
    for flavor in ("tpu", "torch", "tf"):
        cfg = dict(model_type=C.RESNET_18_POINTS_PER_WING, resnet_flavor=flavor, kernel_size=4)
        tm = build_model(Config(**cfg), (48, 48, 4), 18)
        jm = jbuild_model(JConfig(**cfg), (48, 48, 4), 18)
        assert type(tm) is ResNetHeatmapNet and type(jm).__name__ == "ResNetHeatmapNet"
        assert (tm.flavor, tm.deconv1.kernel_size, tm.dtype) == (flavor, (4, 4), torch.bfloat16)
        assert (jm.flavor, jm.kernel_size) == (flavor, 4)
    gpt = build_model(Config(model_type=C.GPTNET, compute_dtype="float32"), (48, 48, 4), 18)
    assert type(gpt) is GPTResNet and gpt.dtype == torch.float32 and gpt.out_channels == 18
    with pytest.raises(ValueError, match="resnet_flavor"):
        build_model(Config(model_type=C.RESNET_18_POINTS_PER_WING, resnet_flavor="keras"),
                    (48, 48, 4), 18)
