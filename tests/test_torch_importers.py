"""The port's reference-checkpoint importers against the JAX package's.

Every checkpoint is built here, as ``tests/test_importers.py`` builds them
(its reference-layout torch modules and keras-layout h5 writers are imported
from it): the port's ``ImportedModel`` must equal JAX's -- ``model_kind``,
``arch_flavor``, ``arch_kwargs``, and params and ``batch_stats`` key for
key, bit for bit -- which needs no JAX compile. The port's built module is
then held to the reference torch module's own forward (NHWC against NCHW,
float32) and, for a few keras saves, to JAX's ``apply`` of the imported
tree. Then the integrations: the torchvision trunk and the self-supervised
reference checkpoint as ``pretrained_encoder_path``, a keras C2F coarse
model in the ``Trainer``, snapshots both ways, the encoder-only import
refusing to serve, ``cli import`` and ``cli infer --import-reference``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_estimation_amitai_torch import cli, importers
from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.data.synthetic import make_synthetic_arrays, write_synthetic_h5
from pose_estimation_amitai_torch.infer import Predictor
from pose_estimation_amitai_torch.train.trainer import Trainer
from pose_estimation_amitai_tpu import importers as jimporters

from test_importers import (
    _gen_keras_cnn_weights,
    _gen_keras_resnet_weights,
    _randomize_torch,
    _RefBasicNet,
    _RefCustomViT,
    _RefDisentangled,
    _RefFourCams,
    _RefViTDecoder,
    _RefViTNet,
    _TVResNet50,
    _write_keras_h5,
    _write_keras_h5_nested_c2f,
    _write_keras_resnet_h5,
    _write_keras_vit_h5,
)
from test_torch_resnet import one_thread  # noqa: F401 (a fixture)

nn = torch.nn
F32_RTOL = 1e-5  # the port's module vs the reference's forward, of max|reference|
# the ViT against the reference torch module: the port's ViT, as JAX's, takes
# flax's LayerNorm epsilon (1e-6) and tanh GELU where the reference's torch
# module takes 1e-5 and the erf GELU (tests/test_importers.py holds this
# case at 2e-4); the port is held to JAX's apply of the same tree at F32_RTOL
VIT_REF_RTOL = 2e-4


@pytest.fixture(autouse=True)
def _one_thread_here(one_thread):
    """Every case on one intra-op thread (workers of the parallel run share
    the cores)."""


# ---------------------------------------------------------------------------
# checkpoints, each with its reference forward where the reference is torch
# ---------------------------------------------------------------------------
class _AmbiguousViT(nn.Module):
    """A ViT trained with 'dim head' falsy: dim_head 64, 2 heads at dim 128,
    whose qkv width is a multiple of both dim and 64."""

    def __init__(self):
        super().__init__()
        self.vit_encoder = _RefCustomViT(48, 16, 128, 1, heads=2, dim_head=64, mlp_dim=256)
        self.cnn_decoder = _RefViTDecoder(128, 4, grid=3)

    def forward(self, x):
        return self.cnn_decoder(self.vit_encoder(x))


def _torch_case(tmp_path, name):
    """(path, reference forward on NCHW, inputs NCHW, extra args, kw)."""
    if name == "basic_checkpoint":
        torch.manual_seed(0)
        net = _RefBasicNet(4, 6).eval()
        path = str(tmp_path / "checkpoint.pth")
        torch.save({"epoch": 3, "model_state_dict": net.state_dict(), "loss": 0.1}, path)
        return path, net, torch.rand(2, 4, 48, 48), (), {}
    if name == "basic_torchscript":
        torch.manual_seed(1)
        net = _RefBasicNet(4, 5).eval()
        path = str(tmp_path / "best_model.pth")
        torch.jit.script(net).save(path)
        return path, net, torch.rand(1, 4, 48, 48), (), {}
    if name == "vit":
        torch.manual_seed(2)
        net = _RefViTNet().eval()
        path = str(tmp_path / "vit_checkpoint.pth")
        torch.save({"model_state_dict": net.state_dict()}, path)
        # batch 1: the reference's batch-global min-max is then per sample
        return path, net, torch.rand(1, 4, 48, 48), (), {}
    if name == "vit_dim_head":
        torch.manual_seed(6)
        net = _AmbiguousViT().eval()
        path = str(tmp_path / "ambig_vit.pth")
        torch.save(net.state_dict(), path)
        return path, net, torch.rand(1, 4, 48, 48), (), {"dim_head": 64}
    if name == "multicam":
        torch.manual_seed(5)
        net = _RefFourCams(4, 8).eval()
        path = str(tmp_path / "four_cams.pth")
        torch.save({"model_state_dict": net.state_dict()}, path)
        return path, net, torch.rand(2, 16, 48, 48), (), {}
    if name == "disentangled":
        torch.manual_seed(6)
        net = _RefDisentangled(4, 8)
        with torch.no_grad():
            for bn in (net.batch_norm1, net.batch_norm2, net.batch_norm3):
                bn.running_mean.uniform_(-0.2, 0.2)
                bn.running_var.uniform_(0.5, 1.5)
        net = net.eval()
        path = str(tmp_path / "disentangled.pth")
        torch.save({"model_state_dict": net.state_dict()}, path)
        p = torch.rand(2, 4, 3, 4) * 0.5
        return path, net, torch.rand(2, 16, 48, 48), (p, torch.linalg.pinv(p)), {}
    if name == "torchvision_resnet50":
        m = _TVResNet50((1, 1, 1, 1))
        _randomize_torch(m, 7)
        path = str(tmp_path / "tv_resnet50.pth")
        torch.save(m.state_dict(), path)
        return path, None, None, (), {}
    raise KeyError(name)


def _keras_case(tmp_path, name):
    """(path, the generated weights) of a keras-layout save."""
    if name == "keras_basic":
        rng = np.random.default_rng(0)
        enc, dec = _gen_keras_cnn_weights(rng, 8, 4, 6, 2)
        path = str(tmp_path / "best_model.h5")
        _write_keras_h5(path, enc, dec)
        return path, 4
    if name == "keras_two_wings":
        rng = np.random.default_rng(11)
        enc, dec = _gen_keras_cnn_weights(rng, 8, 4, 4, 2, dec_in_ratio=2)
        path = str(tmp_path / "two_wings.h5")
        _write_keras_h5(path, enc, dec)
        return path, 5
    if name == "keras_all_4_cams":
        rng = np.random.default_rng(12)
        enc, dec = _gen_keras_cnn_weights(rng, 8, 4, 2, 2, dec_in_ratio=5)
        path = str(tmp_path / "all_4_cams.h5")
        _write_keras_h5(path, enc, dec)
        return path, 16
    if name in ("keras_c2f", "keras_coarse"):
        rng = np.random.default_rng(21)
        enc1, dec1 = _gen_keras_cnn_weights(rng, 4, 4, 5, 3)
        path = str(tmp_path / f"{name}.h5")
        if name == "keras_coarse":
            _write_keras_h5(path, enc1, dec1)
        else:
            enc2, dec2 = _gen_keras_cnn_weights(rng, 8, 4 + 5, 6, 2)
            _write_keras_h5_nested_c2f(path, enc1, dec1, enc2, dec2)
        return path, 4
    if name == "keras_resnet50":
        rng = np.random.default_rng(31)
        entries, deconvs = _gen_keras_resnet_weights(rng, 4, (1, 1, 1, 1), 4, 3)
        path = str(tmp_path / "resnet.h5")
        _write_keras_resnet_h5(path, entries, deconvs)
        return path, 4
    if name == "keras_vit":
        rng = np.random.default_rng(7)
        p, dim, heads, dim_head, depth, cout, cin = 16, 24, 2, 24, 2, 5, 4
        n = (48 // p) ** 2

        def w(*shape):
            return rng.normal(0, 0.1, shape).astype(np.float32)

        blocks = [{
            "q": (w(dim, heads, dim_head), w(heads, dim_head)),
            "k": (w(dim, heads, dim_head), w(heads, dim_head)),
            "v": (w(dim, heads, dim_head), w(heads, dim_head)),
            "o": (w(heads, dim_head, dim), w(dim)),
            "ln1": (1.0 + w(dim), w(dim)), "ln2": (1.0 + w(dim), w(dim)),
            "fc1": (w(dim, 4 * dim), w(4 * dim)), "fc2": (w(4 * dim, dim), w(dim)),
        } for _ in range(depth)]
        deconvs, c = [], dim
        for wd in (dim // 2, dim // 4, dim // 8, cout):
            deconvs.append((w(3, 3, wd, c), w(wd)))
            c = wd
        path = str(tmp_path / "vit_model.h5")
        _write_keras_vit_h5(path, (w(p * p * cin, dim), w(dim)), w(n, dim), blocks, deconvs)
        return path, cin
    raise KeyError(name)


TORCH_CASES = ("basic_checkpoint", "basic_torchscript", "vit", "vit_dim_head", "multicam",
               "disentangled", "torchvision_resnet50")
KERAS_CASES = ("keras_basic", "keras_two_wings", "keras_all_4_cams", "keras_c2f",
               "keras_coarse", "keras_resnet50", "keras_vit")


def _assert_trees_equal(got, want, where: str) -> None:
    assert isinstance(got, dict) == isinstance(want, dict), where
    if not isinstance(want, dict):
        assert got.dtype == np.asarray(want).dtype, where
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=where)
        return
    assert sorted(got) == sorted(want), where
    for k in want:
        _assert_trees_equal(got[k], want[k], f"{where}/{k}")


def _assert_imports_equal(got: importers.ImportedModel, want) -> None:
    assert got.model_kind == want.model_kind
    assert got.arch_flavor == want.arch_flavor
    assert got.arch_kwargs == want.arch_kwargs
    _assert_trees_equal(got.params, want.params, "params")
    _assert_trees_equal(got.batch_stats or {}, want.batch_stats or {}, "batch_stats")


@pytest.mark.parametrize("case", TORCH_CASES + KERAS_CASES)
def test_import_equals_jax_importer(tmp_path, case):
    if case in TORCH_CASES:
        path, _, _, _, kw = _torch_case(tmp_path, case)
    else:
        path, _ = _keras_case(tmp_path, case)
        kw = {}
    assert importers.is_reference_checkpoint(path)
    got = importers.import_reference_checkpoint(path, **kw)
    want = jimporters.import_reference_checkpoint(path, **kw)
    _assert_imports_equal(got, want)


def test_vit_dim_head_guess_warns(tmp_path):
    """Only the product heads x dim_head is in the shapes: the default guess
    warns, as JAX's does, and the override recovers the true split."""
    path, _, _, _, _ = _torch_case(tmp_path, "vit_dim_head")
    with pytest.warns(UserWarning, match="divisible by both"):
        guessed = importers.import_torch_checkpoint(path)
    assert (guessed.arch_kwargs["dim_head"], guessed.arch_kwargs["heads"]) == (128, 1)
    fixed = importers.import_torch_checkpoint(path, dim_head=64)
    assert (fixed.arch_kwargs["dim_head"], fixed.arch_kwargs["heads"]) == (64, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


@pytest.mark.parametrize("case", TORCH_CASES[:-1])
def test_built_module_matches_reference_forward(tmp_path, case):
    """The port's module of the imported tree against the reference torch
    module's own forward, float32."""
    path, net, x, extra, kw = _torch_case(tmp_path, case)
    with torch.no_grad():
        ref = net(x, *extra)
    model = importers.import_reference_checkpoint(path, **kw).build_model("cpu", torch.float32)
    with torch.no_grad():
        got = model(_nhwc(x), *extra).permute(0, 3, 1, 2)
    top = float(ref.abs().max())
    err = float((got - ref).abs().max())
    assert err <= (VIT_REF_RTOL if "vit" in case else F32_RTOL) * top, (err, top)
    if "vit" in case:
        jimp = jimporters.import_reference_checkpoint(path, **kw)
        want = np.asarray(jimp.build_model(dtype=jnp.float32).apply(
            {"params": jax.tree_util.tree_map(jnp.asarray, jimp.params)},
            jnp.asarray(_nhwc(x).numpy()), train=False))
        got = got.permute(0, 2, 3, 1).numpy()
        assert float(np.abs(got - want).max()) <= F32_RTOL * float(np.abs(want).max())


@pytest.mark.parametrize("case", ["keras_basic", "keras_c2f", "keras_resnet50", "keras_vit"])
def test_built_module_matches_jax_apply_keras(tmp_path, case):
    """A keras save has no torch forward to hold the port to: its imported
    module against JAX's ``apply`` of the same imported tree, float32."""
    path, cin = _keras_case(tmp_path, case)
    x = np.random.default_rng(3).random((2, 64 if case == "keras_resnet50" else 48,
                                         64 if case == "keras_resnet50" else 48, cin),
                                        dtype=np.float32)
    jimp = jimporters.import_reference_checkpoint(path)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, jimp.params)}
    if jimp.batch_stats:
        variables["batch_stats"] = jax.tree_util.tree_map(jnp.asarray, jimp.batch_stats)
    want = np.asarray(jimp.build_model(dtype=jnp.float32).apply(
        variables, jnp.asarray(x), train=False))
    model = importers.import_reference_checkpoint(path).build_model("cpu", torch.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    top = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= F32_RTOL * top


def test_port_files_are_not_reference_checkpoints(tmp_path):
    """The port's own .pt files are torch.save archives too: their keys
    match no reference layout, so they are not taken for one."""
    cfg = Config(num_base_filters=8, epochs=1, batch_size=2, batches_per_epoch=1,
                 base_output_path=str(tmp_path), do_augmentations=False,
                 val_fraction=0.5, seed=0, async_checkpoint=False)
    tr = Trainer(cfg, arrays=make_synthetic_arrays(num_frames=2, num_points=8, image_size=48),
                 device="cpu")
    tr.train()
    for name in ("best_model.pt", "checkpoint.pt", "initial_model.pt"):
        assert not importers.is_reference_checkpoint(os.path.join(tr.run_path, name)), name
    assert not importers.is_reference_checkpoint(tr.run_path)
    path, *_ = _torch_case(tmp_path, "basic_torchscript")
    assert importers.archive_kind(path) == "torchscript"


def test_adapt_stem_in_channels_equals_jax_and_keeps_grayscale():
    rng = np.random.default_rng(3)
    k3 = rng.normal(0, 0.1, (7, 7, 3, 8)).astype(np.float32)
    k4 = importers.adapt_stem_in_channels(k3, 4)
    np.testing.assert_array_equal(k4, jimporters.adapt_stem_in_channels(k3, 4))
    assert importers.adapt_stem_in_channels(k3, 3) is k3
    gray = torch.from_numpy(rng.random((1, 1, 16, 16)).astype(np.float32))

    def conv(v, k):
        return torch.nn.functional.conv2d(v, torch.from_numpy(k).permute(3, 2, 0, 1),
                                          stride=2, padding=3)

    np.testing.assert_allclose(conv(gray.repeat(1, 4, 1, 1), k4),
                               conv(gray.repeat(1, 3, 1, 1), k3), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------
def test_snapshots_both_ways(tmp_path):
    """The port writes torch.save snapshots with its marker and reads them
    back bit for bit; it reads JAX's (magic + msgpack, and the legacy
    magic-less payload) through its jax-free reader; weights.load_checkpoint
    strips JAX's magic; near-miss and junk files are not snapshots."""
    from flax import serialization

    from pose_estimation_amitai_torch import weights

    rng = np.random.default_rng(33)
    entries, deconvs = _gen_keras_resnet_weights(rng, 4, (1, 1, 1, 1), 4, 3)
    ref = str(tmp_path / "resnet.h5")
    _write_keras_resnet_h5(ref, entries, deconvs)
    imported = importers.import_reference_checkpoint(ref)

    ours = str(tmp_path / "snap.pt")
    importers.save_imported_snapshot(imported, ours)
    assert importers.archive_kind(ours) == "torch_save"
    assert not importers.is_reference_checkpoint(ours)
    _assert_imports_equal(importers.load_imported_snapshot(ours), imported)

    theirs = str(tmp_path / "snap.msgpack")
    jimporters.save_imported_snapshot(jimporters.import_reference_checkpoint(ref), theirs)
    _assert_imports_equal(importers.load_imported_snapshot(theirs), imported)
    params, stats = weights.load_checkpoint(theirs)
    _assert_trees_equal(params, imported.params, "params")
    _assert_trees_equal(stats, imported.batch_stats, "batch_stats")
    params, stats = weights.load_flax_checkpoint(theirs)
    _assert_trees_equal(params, imported.params, "params")

    legacy = str(tmp_path / "legacy.msgpack")
    with open(legacy, "wb") as f:
        f.write(serialization.to_bytes({
            "format": importers.IMPORT_SNAPSHOT_FORMAT, "params": imported.params,
            "batch_stats": {}, "meta": json.dumps({
                "model_kind": "resnet", "arch_flavor": "tf",
                "arch_kwargs": imported.arch_kwargs})}))
    assert importers.load_imported_snapshot(legacy).arch_flavor == "tf"
    near = str(tmp_path / "near.msgpack")
    with open(near, "wb") as f:
        f.write(serialization.to_bytes({"formatter": {"x": np.zeros(2)}}))
    assert importers.load_imported_snapshot(near) is None
    junk = str(tmp_path / "junk.bin")
    with open(junk, "wb") as f:
        f.write(b"\x81")
    assert importers.load_imported_snapshot(junk) is None
    assert importers.load_imported_snapshot(str(tmp_path)) is None


def test_imported_snapshot_serves_from_its_own_architecture(tmp_path):
    """A snapshot rebuilds its model from its metadata, not from the config
    (whose defaults describe the flagship): a keras ResNet50 snapshot through
    Predictor.from_checkpoint equals the module built from the import."""
    rng = np.random.default_rng(33)
    entries, deconvs = _gen_keras_resnet_weights(rng, 4, (1, 1, 1, 1), 4, 3)
    ref = str(tmp_path / "resnet.h5")
    _write_keras_resnet_h5(ref, entries, deconvs)
    snap = str(tmp_path / "imported.pt")
    assert cli.main(["import", ref, snap]) == 0
    x = rng.random((3, 64, 64, 4)).astype(np.float32)
    pred = Predictor.from_checkpoint(Config(compute_dtype="float32"), snap, (64, 64, 4),
                                     device="cpu", chunk_size=2, return_heatmaps=True)
    assert pred.serving_path == "module" and pred.num_output_channels == 3
    maps, _ = pred(x)
    model = importers.import_reference_checkpoint(ref).build_model("cpu", torch.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(maps, want, rtol=1e-5, atol=1e-6)


def test_encoder_only_import_refuses_to_serve(tmp_path):
    path, *_ = _torch_case(tmp_path, "torchvision_resnet50")
    snap = str(tmp_path / "tv_snap.pt")
    importers.save_imported_snapshot(importers.import_reference_checkpoint(path), snap)
    for ckpt in (path, snap):
        with pytest.raises(ValueError, match="ENCODER-INIT"):
            Predictor.from_checkpoint(Config(), ckpt, image_shape=(48, 48, 3),
                                      num_output_channels=5, device="cpu")


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------
def _trainer_cfg(tmp_path, **kw):
    return Config(epochs=1, batch_size=2, batches_per_epoch=1,
                  base_output_path=str(tmp_path / "runs"), do_augmentations=False,
                  val_fraction=0.5, seed=0, async_checkpoint=False, **kw)


@pytest.mark.parametrize("source", ["pth", "snapshot"])
def test_trainer_imagenet_resnet_encoder_init(tmp_path, source):
    """A torchvision resnet50 state dict (or its `cli import` snapshot) as
    pretrained_encoder_path: the trunk and its BN statistics grafted into
    the trainer's state, the 3-channel stem inflated to the frames' 4."""
    m = _TVResNet50()
    _randomize_torch(m, 11)
    sd = m.state_dict()
    path = str(tmp_path / "imagenet_resnet50.pth")
    torch.save(sd, path)
    if source == "snapshot":
        snap = str(tmp_path / "tv_snapshot.pt")
        assert cli.main(["import", path, snap]) == 0
        path = snap
    cfg = _trainer_cfg(tmp_path, model_type=C.RESNET_18_POINTS_PER_WING,
                       resnet_flavor="torch", pretrained_encoder_path=path)
    tr = Trainer(cfg, arrays=make_synthetic_arrays(num_frames=4, num_points=6, image_size=48,
                                                   seed=0), device="cpu")
    stem = tr.state.params["encoder.stem.weight"]
    want = importers.adapt_stem_in_channels(
        sd["conv1.weight"].numpy().transpose(2, 3, 1, 0), 4).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(stem.numpy(), want)
    np.testing.assert_array_equal(tr.state.params["encoder.stage0_block0.conv2.weight"].numpy(),
                                  sd["layer1.0.conv2.weight"].numpy())
    bs = tr.state.batch_stats
    np.testing.assert_array_equal(bs["encoder.stem_bn.running_mean"].numpy(),
                                  sd["bn1.running_mean"].numpy())
    np.testing.assert_array_equal(bs["encoder.stage3_block0.bn3.running_var"].numpy(),
                                  sd["layer4.0.bn3.running_var"].numpy())


def test_finetune_from_reference_selfsup_checkpoint(tmp_path):
    """A reference torch checkpoint (the pre_trained_leap.pth re-heading
    flow, NNs warehouse/NNs.py:38-62) as pretrained_encoder_path: the
    encoder converted and loaded, the decoder fresh, and training runs."""
    torch.manual_seed(8)
    net = _RefBasicNet(4, 4).eval()  # the self-supervision autoencoder: 4 -> 4
    ckpt = str(tmp_path / "pre_trained_leap.pth")
    torch.save(net.state_dict(), ckpt)
    cfg = _trainer_cfg(tmp_path, num_base_filters=8, pretrained_encoder_path=ckpt)
    tr = Trainer(cfg, arrays=make_synthetic_arrays(num_frames=4, num_points=8, image_size=48),
                 device="cpu")
    for i in range(1, 10):
        np.testing.assert_array_equal(tr.state.params[f"encoder.conv{i}.weight"].numpy(),
                                      net.state_dict()[f"encoder.conv{i}.weight"].numpy())
    history = tr.train()
    assert np.isfinite(history["train_loss"][0])


def test_trainer_c2f_coarse_from_reference_h5(tmp_path):
    """The reference's own C2F flow: coarse_model_path at a trained keras
    coarse save loads the frozen coarse stage from the .h5, equal to JAX's
    Trainer's."""
    from pose_estimation_amitai_torch import weights

    rng = np.random.default_rng(51)
    enc, dec = _gen_keras_cnn_weights(rng, 4, 4, 5, 3)
    h5 = str(tmp_path / "coarse_sigma6.h5")
    _write_keras_h5(h5, enc, dec)
    cfg = _trainer_cfg(tmp_path, model_type=C.C2F_PER_WING, num_base_filters=4,
                       coarse_model_path=h5)
    tr = Trainer(cfg, arrays=make_synthetic_arrays(num_frames=4, num_points=8, image_size=48,
                                                   seed=0), device="cpu")
    coarse = weights.state_dict_to_flax(
        {k[len("coarse."):]: v for k, v in tr.state.params.items() if k.startswith("coarse.")},
        tr.model.coarse)
    _assert_trees_equal(coarse, jimporters.import_reference_checkpoint(h5).params, "coarse")
    assert np.isfinite(tr.train()["train_loss"][0])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_import_and_infer_import_reference(tmp_path):
    """``cli import`` writes a snapshot equal to the import; ``cli infer
    --import-reference`` serves a reference torch checkpoint directly, its
    peaks those of the snapshot served by ``cli infer``."""
    torch.manual_seed(3)
    net = _RefBasicNet(4, 5).eval()
    ckpt = str(tmp_path / "checkpoint.pth")
    torch.save({"model_state_dict": net.state_dict()}, ckpt)
    snap = str(tmp_path / "imported.pt")
    assert cli.main(["import", ckpt, snap]) == 0
    _assert_imports_equal(importers.load_imported_snapshot(snap),
                          importers.import_reference_checkpoint(ckpt))

    data = str(tmp_path / "data.h5")
    write_synthetic_h5(data, num_frames=3, num_points=8, image_size=48)
    cfg_path = str(tmp_path / "config.json")
    with open(cfg_path, "w") as f:
        json.dump({"model type": C.MODEL_18_POINTS_PER_WING, "batch size": 4}, f)
    outs = []
    for src, flag in ((ckpt, ["--import-reference"]), (snap, [])):
        out = str(tmp_path / f"preds{len(outs)}.npz")
        assert cli.main(["infer", cfg_path, src, data, out, "--chunk-size", "8",
                         "--device", "cpu", *flag]) == 0
        with np.load(out) as z:
            outs.append(z["points_2d"])
            assert "points_3d" in z.files
    assert outs[0].shape[1:] == (3, 5)
    np.testing.assert_array_equal(outs[0], outs[1])
