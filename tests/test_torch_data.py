"""The port's data layer against the JAX package (CPU): synthetic arrays and
the H5 round trip equal, the flagship Preprocessor's outputs equal
(including the two paths through the port's torch ops: the body masks of
the 3-good-cameras ranking and the 3D consistency checker), the dataset's
split, ring and refined peaks (indices equal, peaks within 1e-5), and the
model registry's layout helpers."""

import numpy as np
import pytest

from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.data import (
    DeviceDataset, HostDataset, Preprocessor, build_dataset, make_synthetic_arrays,
    write_synthetic_h5,
)
from pose_estimation_amitai_torch import models
from pose_estimation_amitai_tpu import models as jmodels
from pose_estimation_amitai_tpu.config import Config as JConfig
from pose_estimation_amitai_tpu.data import pipeline as jpipeline
from pose_estimation_amitai_tpu.data import preprocess as jpreprocess
from pose_estimation_amitai_tpu.data import synthetic as jsynthetic


@pytest.fixture(scope="module")
def arrays():
    return make_synthetic_arrays(num_frames=3, num_points=8, image_size=48, seed=0)


@pytest.mark.parametrize("kw", [{}, {"motion": "movie", "layout": "outline"}])
def test_synthetic_arrays_equal_jax(kw):
    got = make_synthetic_arrays(num_frames=2, num_points=8, image_size=48, seed=3, **kw)
    want = jsynthetic.make_synthetic_arrays(num_frames=2, num_points=8, image_size=48,
                                            seed=3, **kw)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_h5_round_trip_equals_jax_loader(tmp_path):
    path = write_synthetic_h5(str(tmp_path / "d.h5"), num_frames=2, num_points=8,
                              image_size=32, seed=1)
    got = Preprocessor._load_h5(path)
    want = jpreprocess.Preprocessor._load_h5(path)
    ref = make_synthetic_arrays(num_frames=2, num_points=8, image_size=32, seed=1)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("model_type, extra", [
    (C.MODEL_18_POINTS_PER_WING, {}),
    (C.MODEL_18_POINTS_PER_WING, {"ensure_3d_consistency": True, "mask_dilation": 2}),
    (C.MODEL_18_POINTS_3_GOOD_CAMERAS, {}),
    (C.ALL_CAMS_18_POINTS, {}),
])
def test_preprocessor_outputs_equal_jax(arrays, model_type, extra):
    pre = Preprocessor(Config(model_type=model_type, **extra), arrays)
    jpre = jpreprocess.Preprocessor(JConfig(model_type=model_type, **extra), arrays)
    pre.do_preprocess()
    jpre.do_preprocess()
    for name in ("get_box", "get_confmaps", "get_points_3D_per_wing",
                 "get_cropzone_per_wing"):
        np.testing.assert_array_equal(getattr(pre, name)(), getattr(jpre, name)(),
                                      err_msg=name)


def test_consistency_checker_flips_equal_jax(arrays):
    """A frame whose camera 2 has its wings swapped is repaired the same
    way by both packages (the scores go through the port's geometry)."""
    swapped = {k: v.copy() for k, v in arrays.items()}
    half = 4
    cm = swapped["confmaps"]
    cm[1, 2, ..., :half], cm[1, 2, ..., half:2 * half] = (
        cm[1, 2, ..., half:2 * half].copy(), cm[1, 2, ..., :half].copy())
    cfg, jcfg = Config(), JConfig()
    pre, jpre = Preprocessor(cfg, swapped), jpreprocess.Preprocessor(jcfg, swapped)
    f, c, h, w, k = pre.confmaps.shape
    pts = jpreprocess.find_peaks_np(pre.confmaps.reshape(-1, h, w, k))[:, :2, :]
    pts = np.transpose(pts.reshape(f, c, 2, k), (0, 1, 3, 2))[:, :, :2 * half]
    got = pre.ensure_right_left_consistency(pts)
    want = jpre.ensure_right_left_consistency(pts)
    np.testing.assert_array_equal(got, want)
    assert got[1].tolist() == [False, True, False] and not got[0].any()


def test_body_masks_equal_jax(arrays):
    pre, jpre = Preprocessor(Config(), arrays), jpreprocess.Preprocessor(JConfig(), arrays)
    for p in (pre, jpre):
        p.split_per_wing(p.box, p.confmaps[..., :-2], C.PER_WING_MODEL, C.RANDOM_TRAIN_SET)
    (m, s), (jm, js) = pre.get_body_masks(), jpre.get_body_masks()
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(s, js)
    assert s.sum() > 0


def test_device_dataset_split_ring_and_peaks_equal_jax(arrays):
    cfg, jcfg = Config(), JConfig()
    ds, _ = build_dataset(cfg, arrays, device="cpu")
    jds, _ = jpipeline.build_dataset(jcfg, arrays)
    assert type(ds) is DeviceDataset
    np.testing.assert_array_equal(ds.val_inds, jds.val_inds)
    np.testing.assert_array_equal(ds.train_inds, jds.train_inds)
    for k in ("box", "confmaps"):
        np.testing.assert_array_equal(ds.data[k].numpy(), np.asarray(jds.data[k]))
    for k in ("peaks", "peak_vals"):
        np.testing.assert_allclose(ds.data[k].numpy(), np.asarray(jds.data[k]),
                                   atol=1e-5, rtol=0)
    for _ in range(3):
        np.testing.assert_array_equal(ds.step_indices(5, 2), jds.step_indices(5, 2))
    ds.shuffle_train_indices()
    jds.shuffle_train_indices()
    np.testing.assert_array_equal(ds.step_indices(7, 1), jds.step_indices(7, 1))
    got = [(i.tolist(), n) for i, n in ds.val_batches(5)]
    assert got == [(i.tolist(), n) for i, n in jds.val_batches(5)]
    for (b, n), (jb, jn) in zip(ds.val_payloads(5), jds.val_payloads(5)):
        assert n == jn
        for k in b:
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
    got, want = ds.gather([3, 0, 5]), jds.gather(np.asarray([3, 0, 5]))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    data, idx = ds.step_payload(np.zeros((2, 3), np.int32))
    assert data is ds.data and idx.shape == (2, 3)


def test_host_dataset_ships_the_step_window(arrays):
    ds, _ = build_dataset(Config(host_resident_data=True), arrays, device="cpu")
    assert type(ds) is HostDataset
    idx = ds.step_indices(4, 2)
    window, local = ds.step_payload(idx)
    assert set(window) == {"box", "peaks", "peak_vals"} and local.tolist() == [
        [0, 1, 2, 3], [4, 5, 6, 7]]
    np.testing.assert_array_equal(window["box"].numpy(),
                                  ds.data["box"].numpy()[idx.reshape(-1)])


def test_disentangled_dataset_is_refused(arrays):
    """The disentangled types' dataset, once refused (its parity with JAX is
    tests/test_torch_disentangled.py's): the cameras ride in the host
    dataset's step window too."""
    cfg = Config(model_type=C.ALL_CAMS_DISENTANGLED_PER_WING_CNN, host_resident_data=True)
    ds, _ = build_dataset(cfg, {k: v.copy() for k, v in arrays.items()}, device="cpu")
    assert type(ds) is HostDataset
    idx = ds.step_indices(2, 2)
    window, local = ds.step_payload(idx)
    assert set(window) == {"box", "peaks", "peak_vals", "P", "P_inv"}
    assert tuple(window["P"].shape) == (4, 4, 3, 4) and tuple(window["P_inv"].shape) == (4, 4, 4, 3)
    np.testing.assert_array_equal(window["P"].numpy(), ds.data["P"].numpy()[idx.reshape(-1)])


@pytest.mark.parametrize("fn", ["needs_camera_matrices", "augmentation_views",
                                "layout_views", "layout_masks_per_view"])
def test_layout_helpers_equal_jax(fn):
    types = [v for k, v in vars(C).items() if k.isupper() and isinstance(v, str)]
    assert len(types) > 30
    for mt in types:
        assert getattr(models, fn)(mt) == getattr(jmodels, fn)(mt), (fn, mt)
