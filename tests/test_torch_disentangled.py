"""The port's disentangled 4-camera model (``FourCamDisentangled``) and its
data against the JAX package on the CPU: the model against flax ``apply``
with both FTL layouts (the per-pixel channel grouping and the reference's
raw NCHW reinterpret), float32 within atol 2e-5 both ways through the
bridge, ``batch_stats`` included, bf16 within 3% of the maps' max; the
shared ``bn3``'s four updates a forward; ``build_dataset``'s samples and
cameras; augmentation folded into the cameras; the padded serving tail.

Frames (2, 48, 48, 16), filters 8, 24 maps; cameras the crop-adjusted ones
of the synthetic data (unit Frobenius norm, as the pipeline makes them)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch import weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.data import build_dataset, make_synthetic_arrays
from pose_estimation_amitai_torch.data.pipeline import estimate_cameras_from_peaks
from pose_estimation_amitai_torch.data.preprocess import find_peaks_np
from pose_estimation_amitai_torch.infer import Predictor
from pose_estimation_amitai_torch.models import FourCamDisentangled, build_model
from pose_estimation_amitai_torch.models.norm import BatchNorm
from pose_estimation_amitai_torch.ops import affine, geometry, peaks
from pose_estimation_amitai_torch.train import loop
from pose_estimation_amitai_tpu.config import Config as JConfig
from pose_estimation_amitai_tpu.data.pipeline import build_dataset as jbuild_dataset
from pose_estimation_amitai_tpu.models import build_model as jbuild_model

from test_torch_resnet import (  # noqa: F401 (fixtures)
    _one_thread_here, check_training_stats, one_thread, own_variables, seeded_variables,
)

MT = C.ALL_CAMS_DISENTANGLED_PER_WING_CNN
ATOL = 2e-5
BF16_RTOL = 3e-2
CAM_ATOL = 1e-5  # unit-norm cameras, float32
K = 24


@pytest.fixture(scope="module")
def arrays():
    return make_synthetic_arrays(num_frames=2, num_points=8, image_size=48, seed=0)


@pytest.fixture(scope="module")
def samples(arrays):
    """Frames and cameras of the disentangled dataset (the pipeline's)."""
    ds, _ = build_dataset(Config(model_type=MT), {k: v.copy() for k, v in arrays.items()},
                          device="cpu")
    return {k: ds.data[k].numpy() for k in ("box", "P", "P_inv")}


def _models(ref_layout=False, dtype="float32", dropout=0.5):
    kw = dict(model_type=MT, num_base_filters=8, compute_dtype=dtype, dropout_ratio=dropout)
    jm = jbuild_model(JConfig(**kw), (48, 48, 16), K).clone(ref_ftl_layout=ref_layout)
    tm = build_model(Config(**kw), (48, 48, 16), K)
    tm.ref_ftl_layout = ref_layout
    return jm, tm


def _inputs(samples, n=2):
    return samples["box"][:n], samples["P"][:n], samples["P_inv"][:n]


@pytest.mark.parametrize("ref_layout", [False, True], ids=["grouped", "reference-layout"])
def test_model_matches_flax_apply_both_ways(samples, ref_layout):
    jm, tm = _models(ref_layout)
    assert type(tm) is FourCamDisentangled and type(jm).__name__ == "FourCamDisentangled"
    x, P, P_inv = _inputs(samples)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0)},
                                            *map(jnp.asarray, (x, P, P_inv)), train=False))
    apply = jax.jit(lambda p, s, *a: jm.apply({"params": p, "batch_stats": s}, *a, train=False))
    variables = seeded_variables(shapes, seed=1)
    assert set(variables["batch_stats"]) == {"bn1", "bn2", "bn3"}
    want = np.asarray(apply(variables["params"], variables["batch_stats"],
                            *map(jnp.asarray, (x, P, P_inv))))
    tm.load_state_dict(weights.flax_to_state_dict(variables["params"], tm,
                                                  variables["batch_stats"]))
    with torch.no_grad():
        got = tm.eval()(*map(torch.from_numpy, (x, P, P_inv))).numpy()
    assert got.shape == want.shape == (2, 48, 48, K) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)

    params, stats = own_variables(tm, seed=3)
    tree, stats_tree = weights.state_dict_to_flax(params, tm), weights.batch_stats_to_flax(stats)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda s: 0, shapes["params"]))
    want = np.asarray(apply(tree, stats_tree, *map(jnp.asarray, (x, P, P_inv))))
    got = loop.make_predict_fn(tm)(params, *map(torch.from_numpy, (x, P, P_inv)),
                                   batch_stats=stats).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_bf16_close_to_flax_bf16(samples):
    jm, tm = _models(dtype="bfloat16")
    x, P, P_inv = _inputs(samples)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0)},
                                            *map(jnp.asarray, (x, P, P_inv)), train=False))
    variables = seeded_variables(shapes, seed=2)
    want = np.asarray(jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
        variables, *map(jnp.asarray, (x, P, P_inv))))
    tm.load_state_dict(weights.flax_to_state_dict(variables["params"], tm,
                                                  variables["batch_stats"]))
    assert tm.rearrange1.weight.dtype == torch.bfloat16
    assert all(m.weight.dtype == torch.float32 for m in tm.modules() if isinstance(m, BatchNorm))
    with torch.no_grad():
        got = tm.eval()(*map(torch.from_numpy, (x, P, P_inv))).numpy()
    np.testing.assert_allclose(got, want, atol=BF16_RTOL * np.abs(want).max())


@pytest.mark.parametrize("ref_layout", [False, True], ids=["grouped", "reference-layout"])
def test_shared_bn3_updates_four_times_as_flax(samples, ref_layout):
    """``bn3`` is one module applied to each view: four momentum updates in
    view order, each with one view's batch statistics."""
    jm, tm = _models(ref_layout, dropout=0.0)
    check_training_stats(jm, tm, *_inputs(samples))


def test_build_dataset_equals_jax(arrays):
    cfg = dict(model_type=MT, batch_size=2)
    ds, _ = build_dataset(Config(**cfg), {k: v.copy() for k, v in arrays.items()}, device="cpu")
    jds, _ = jbuild_dataset(JConfig(**cfg), {k: v.copy() for k, v in arrays.items()})
    assert set(ds.data) == {"box", "confmaps", "P", "P_inv", "peaks", "peak_vals"}
    assert ds.data["box"].shape == (4, 48, 48, 16) and ds.data["P"].shape == (4, 4, 3, 4)
    for key in ("box", "confmaps"):
        np.testing.assert_array_equal(ds.data[key].numpy(), np.asarray(jds.data[key]))
    P, P_inv = ds.data["P"].numpy(), ds.data["P_inv"].numpy()
    np.testing.assert_allclose(P, np.asarray(jds.data["P"]), atol=CAM_ATOL)
    # the pseudo-inverse is taken in float64: within 1e-6 of the exact one
    # of P, and JAX's float32 one within its own error of about 1e-5 (these
    # cameras' condition numbers are near 5e3)
    exact = np.linalg.pinv(P.astype(np.float64))
    exact /= np.linalg.norm(exact, axis=(-2, -1), keepdims=True)
    np.testing.assert_allclose(P_inv, exact, atol=1e-6)
    np.testing.assert_allclose(P_inv, np.asarray(jds.data["P_inv"]), atol=2 * CAM_ATOL)
    np.testing.assert_array_equal(ds.val_inds, jds.val_inds)
    np.testing.assert_array_equal(ds.train_inds, jds.train_inds)
    # the peaks the augmentation fast path re-renders from
    np.testing.assert_allclose(ds.data["peaks"].numpy(), np.asarray(jds.data["peaks"]),
                               atol=1e-3)
    batch = ds.gather(ds.val_inds)
    val, n = next(ds.val_payloads(8))
    assert n == len(ds.val_inds) and set(val) == set(batch) == {"image", "confmaps", "P", "P_inv"}
    np.testing.assert_array_equal(val["P"].numpy(), ds.data["P"].numpy()[ds.val_inds])


def test_build_dataset_with_estimated_cameras(arrays):
    """``estimate_cameras``: the same samples, each camera the DLT fit to
    the decoded targets of its frame and view in the crop's frame, the 3D
    points in ``confmaps_orig``'s channel order (both wings share it). The
    fits themselves are held to the exact ones in
    tests/test_torch_geometry.py; JAX's float32 fits fit the targets as well
    to within 0.05 px at the median."""
    cfg = dict(model_type=MT, estimate_cameras=True)
    ds, pre = build_dataset(Config(**cfg), {k: v.copy() for k, v in arrays.items()},
                            device="cpu")
    jds, _ = jbuild_dataset(JConfig(**cfg), {k: v.copy() for k, v in arrays.items()})
    for key in ("box", "confmaps"):
        np.testing.assert_array_equal(ds.data[key].numpy(), np.asarray(jds.data[key]))
    P, P_inv = ds.data["P"].numpy(), ds.data["P_inv"].numpy()
    np.testing.assert_array_equal(P[:2], P[2:])
    np.testing.assert_allclose(P_inv, np.linalg.pinv(P), rtol=1e-6)
    pts = pre.points_3d
    order = np.concatenate([pre.right_inds, pre.left_inds, [pts.shape[1] - 2, pts.shape[1] - 1]])
    cm = pre.get_confmaps_orig()
    h = cm.shape[2]

    def misfit(cams):
        """Median reprojection error of the 3D points against the decoded
        crop-local targets, per (frame, camera)."""
        errs = []
        for f in range(2):
            X = np.concatenate([pts[f, order], np.ones((len(order), 1))], 1)
            for c in range(4):
                x, y = find_peaks_np(cm[f, c][None])[0, :2].astype(np.float64)
                uvw = X @ np.asarray(cams[f, c], np.float64).T
                seen = np.stack([x, h - y], 1)
                errs.append(np.median(np.abs(uvw[:, :2] / uvw[:, 2:] - seen)))
        return np.array(errs)

    np.testing.assert_array_equal(P[:2], estimate_cameras_from_peaks(
        cm, pre.cropzone, pts[:, order], crop_local=True)[0])
    ours, theirs = misfit(P), misfit(np.asarray(jds.data["P"]))
    assert ours.max() < 3.0
    np.testing.assert_allclose(ours, theirs, atol=0.05)


def test_augmented_views_reproject_through_their_composed_cameras():
    """Each view's warp folded into its camera (the train step's rule): the
    composed camera projects the 3D points onto the peaks of the maps
    rendered at the warped positions (JAX's
    tests/test_multiview_augment.py::test_compose_affine_into_cameras_reprojection,
    here through the port's augmentation)."""
    size = 96
    arrays = make_synthetic_arrays(num_frames=2, num_points=8, image_size=size, seed=3)
    Ks, Rs, ts = geometry.decompose_camera(torch.from_numpy(arrays["cameras_dlt_array"]))
    P, P_inv = geometry.crop_adjusted_matrices(
        Ks, Rs, ts, torch.as_tensor(arrays["cropZone"], dtype=torch.float32), crop_size=size)
    X = torch.as_tensor(arrays["points_3D"], dtype=torch.float32)  # (F, n, 3)
    Xh = torch.cat([X, torch.ones((*X.shape[:2], 1))], -1)

    def rows(cams):  # (F, 4, 3, 4) -> (F, 4, n, 2) [x, row] pixels
        uvw = torch.einsum("fcij,fnj->fcni", cams, Xh)
        xy = uvw[..., :2] / uvw[..., 2:3]
        return torch.stack([xy[..., 0], size - xy[..., 1]], -1)

    pix = rows(P)
    n = X.shape[1]
    gen = torch.Generator().manual_seed(4)
    images = torch.rand((2, size, size, 16), generator=gen)
    _, maps, mats = affine.augment_views_and_peaks(
        gen, images, pix.reshape(2, 4 * n, 2), torch.ones(2, 4 * n), num_views=4, sigma=3.0,
        rotation_range=30.0, xy_shifts=6.0, zoom_range=(0.8, 1.2))
    new_P, new_P_inv = geometry.compose_affine_into_cameras(mats, P, P_inv, crop_size=size)
    want = peaks.find_peaks_refined(maps)[:, :2].transpose(1, 2).reshape(2, 4, n, 2)
    got = rows(new_P)
    inside = ((got > 4) & (got < size - 5)).all(-1)
    assert inside.float().mean() > 0.8
    np.testing.assert_allclose(got[inside].numpy(), want[inside].numpy(), atol=5e-2)
    eye = new_P @ new_P_inv
    eye = eye / (torch.diagonal(eye, dim1=-2, dim2=-1).sum(-1)[..., None, None] / 3)
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(3), eye.shape), atol=2e-2)


def test_predictor_pads_the_tail_with_the_last_camera(samples):
    """A 2-sample tail of a chunk of 3 (its third row the last sample's
    camera and zero frames) decodes what the same samples decode inside a
    full chunk; without cameras the call raises."""
    _, tm = _models()
    params, stats = own_variables(tm, seed=5)
    x = np.concatenate([samples["box"]] * 2)[:5]
    cams = tuple(np.concatenate([samples[k]] * 2)[:5] for k in ("P", "P_inv"))
    cfg = Config(model_type=MT, num_base_filters=8, compute_dtype="float32")
    tree, stats_tree = weights.state_dict_to_flax(params, tm), weights.batch_stats_to_flax(stats)
    whole = Predictor(cfg, tree, (48, 48, 16), K, device="cpu", chunk_size=5,
                      batch_stats=stats_tree, cameras=cams)
    padded = Predictor(cfg, tree, (48, 48, 16), K, device="cpu", chunk_size=3,
                       batch_stats=stats_tree, cameras=cams, use_fused=True)
    assert padded.serving_path == whole.serving_path == "module"
    np.testing.assert_array_equal(padded(x)[:, :2], whole(x)[:, :2])
    np.testing.assert_array_equal(padded.predict_movie(x), padded(x))
    with pytest.raises(ValueError, match="camera matrices"):
        Predictor(cfg, tree, (48, 48, 16), K, device="cpu", batch_stats=stats_tree)(x)
