"""The port's training-side ops against the JAX package on the same
numpy-seeded inputs (CPU): Gaussian targets and morphology (exact or within
1e-6), the affine matrices, point transforms and gather warps at orders 1
and 3 on fixed parameters (within 1e-5), the training decodes and losses,
and reprojection; then the augmentation draws, whose streams cannot match
JAX's, by their statistics and consistency, and the gather warp against
the separable one (JAX's default, and the port's) at 192 px."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_estimation_amitai_torch.ops import affine, gaussian, geometry, morphology, peaks
from pose_estimation_amitai_tpu.ops import affine as jaffine
from pose_estimation_amitai_tpu.ops import gaussian as jgaussian
from pose_estimation_amitai_tpu.ops import geometry as jgeometry
from pose_estimation_amitai_tpu.ops import morphology as jmorphology
from pose_estimation_amitai_tpu.ops import peaks as jpeaks

T = torch.from_numpy


def _np(x) -> np.ndarray:
    return np.array(x)  # a writable copy, which torch.from_numpy takes


# ---- Gaussian targets -------------------------------------------------------

def test_confmaps_from_peaks_matches_jax(rng):
    pk = rng.uniform(-3, 51, (3, 5, 2)).astype(np.float32)
    got = gaussian.confmaps_from_peaks(T(pk), (48, 40), 3.0).numpy()
    want = _np(jgaussian.confmaps_from_peaks(jnp.asarray(pk), (48, 40), 3.0))
    assert got.shape == want.shape == (3, 48, 40, 5)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_ensure_sigma_matches_jax_and_keeps_dead_channels_zero(rng):
    pk = rng.uniform(5, 40, (2, 4, 2)).astype(np.float32)
    maps = np.asarray(jgaussian.confmaps_from_peaks(jnp.asarray(pk), (48, 48), 5.0))
    maps = maps.copy()
    maps[0, ..., 2] = 0.0  # a missing keypoint
    got = gaussian.ensure_sigma(T(maps), 3.0).numpy()
    want = _np(jgaussian.ensure_sigma(jnp.asarray(maps), 3.0))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert got[0, ..., 2].max() == 0.0 and got[1, ..., 2].max() == 1.0


# ---- morphology ---------------------------------------------------------------

@pytest.mark.parametrize("fn, kw", [
    ("binary_dilation", {}), ("binary_dilation", {"iterations": 3}),
    ("binary_erosion", {}), ("binary_closing", {}),
    ("adjust_mask", {"mask_dilation": 2}), ("dilate_disk", {"radius": 3}),
    ("erode_disk", {"radius": 2}),
])
def test_binary_morphology_matches_jax(rng, fn, kw):
    mask = rng.random((2, 3, 30, 34)) > 0.6
    got = getattr(morphology, fn)(T(mask), **kw).numpy()
    want = _np(getattr(jmorphology, fn)(jnp.asarray(mask), **kw))
    assert got.dtype == want.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


def test_structuring_elements_match_jax():
    for r in (1, 2, 6):
        np.testing.assert_array_equal(morphology.cross(r), jmorphology.cross(r))
        np.testing.assert_array_equal(morphology.disk(r), jmorphology.disk(r))


def test_grey_dilate_cross_and_body_masks_match_jax(rng):
    x = rng.random((2, 20, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(morphology.grey_dilate_cross(T(x)).numpy(),
                                  _np(jmorphology.grey_dilate_cross(jnp.asarray(x))))
    fly = rng.random((2, 2, 40, 40, 3)).astype(np.float32) * 0.5
    fly[:, :, 10:25, 12:30] += 0.5
    got = morphology.body_masks(T(fly), 0.7, 6).numpy()
    want = _np(jmorphology.body_masks(jnp.asarray(fly), 0.7, 6))
    assert got.any() and not got.all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("views, masks_per_view", [(1, None), (4, None), (1, 0)])
def test_random_mask_redilation_keeps_its_contract(rng, views, masks_per_view):
    """Each sample's mask channels are the k-th cross dilation of its own
    for some k < max_dilation (JAX's iterate, ``grey_dilate_cross``); every
    other channel is untouched; about half the samples move."""
    b, c = 64, 4 * views
    img = (rng.random((b, 16, 16, c)) > 0.9).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    out = morphology.random_mask_redilation(gen, T(img), 4, num_views=views,
                                            masks_per_view=masks_per_view).numpy()
    mask_ch = [] if masks_per_view == 0 else [4 * v + 3 for v in range(views)]
    other = [ch for ch in range(c) if ch not in mask_ch]
    np.testing.assert_array_equal(out[..., other], img[..., other])
    if not mask_ch:
        return
    iterates = [img[..., mask_ch]]
    for _ in range(3):
        iterates.append(_np(jmorphology.grey_dilate_cross(jnp.asarray(iterates[-1]))))
    ks = [next(k for k, it in enumerate(iterates) if np.array_equal(out[i][..., mask_ch], it[i]))
          for i in range(b)]
    assert 0.3 < np.mean(np.asarray(ks) > 0) < 0.6, ks


# ---- affine --------------------------------------------------------------------

def _params(mod, b, **kw):
    d = dict(angle_deg=np.zeros(b, np.float32), scale=np.ones(b, np.float32),
             shift_x=np.zeros(b, np.float32), shift_y=np.zeros(b, np.float32),
             flip_h=np.zeros(b, bool), flip_v=np.zeros(b, bool))
    d.update({k: np.asarray(v).reshape(b) for k, v in kw.items()})
    conv = jnp.asarray if mod is jaffine else T
    return mod.AugmentParams(*[conv(np.asarray(d[f])) for f in mod.AugmentParams._fields
                               if f in d])


FIXED = dict(angle_deg=np.float32([13.0, -25.0, 80.0, 170.0]),
             scale=np.float32([1.0, 0.9, 1.1, 1.0]),
             shift_x=np.float32([2.0, -3.5, 0.0, 1.5]),
             shift_y=np.float32([0.0, 1.5, -2.0, 0.0]),
             flip_h=np.array([False, True, False, True]),
             flip_v=np.array([True, False, False, True]))


@pytest.mark.parametrize("shear", [False, True])
def test_affine_matrix_and_points_match_jax(rng, shear):
    kw = dict(FIXED, **({"shear_deg": np.float32([5.0, -8.0, 0.0, 12.0])} if shear else {}))
    got = affine.make_affine_matrix(_params(affine, 4, **kw), 40, 48)
    want = _np(jaffine.make_affine_matrix(_params(jaffine, 4, **kw), 40, 48))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    pts = rng.uniform(0, 48, (4, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(
        affine.transform_points(T(pts), got).numpy(),
        _np(jaffine.transform_points(jnp.asarray(pts), jnp.asarray(want))),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("order", [1, 3])
def test_affine_warp_batch_matches_jax_gather(rng, order):
    img = rng.random((4, 40, 48, 3)).astype(np.float32)
    mats = _np(jaffine.make_affine_matrix(_params(jaffine, 4, **FIXED), 40, 48))
    got = affine.affine_warp_batch(T(img), T(mats), order).numpy()
    want = _np(jaffine.affine_warp_batch(jnp.asarray(img), jnp.asarray(mats), order))
    assert got.shape == want.shape and np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    one = affine.affine_warp(T(img[1]), T(mats[1]), order).numpy()
    np.testing.assert_allclose(
        one, _np(jaffine.affine_warp(jnp.asarray(img[1]), jnp.asarray(mats[1]), order)),
        atol=1e-5, rtol=0)


def test_affine_warp_identity_flips_and_dtype(rng):
    img = rng.random((2, 16, 16, 2)).astype(np.float32)
    ident = affine.make_affine_matrix(_params(affine, 2), 16, 16)
    np.testing.assert_allclose(affine.affine_warp_batch(T(img), ident).numpy(), img,
                               atol=1e-5)
    flip = affine.make_affine_matrix(_params(affine, 2, flip_h=[True, True]), 16, 16)
    np.testing.assert_allclose(affine.affine_warp_batch(T(img), flip).numpy(),
                               img[:, :, ::-1], atol=1e-5)
    out = affine.affine_warp_batch(T(img).bfloat16(), ident, 3)
    assert out.dtype == torch.bfloat16


def test_separable_method_is_refused():
    """Only "separable" (the default) and "exact" name a warp: both run in
    every ``augment_*`` function, and any other name is refused."""
    images, maps = torch.rand(1, 8, 8, 1), torch.rand(1, 8, 8, 1)
    pk, vals = torch.full((1, 1, 2), 4.0), torch.ones(1, 1)
    for method in ("exact", "separable"):
        gen = torch.Generator().manual_seed(0)
        assert affine.augment_pair(gen, images, maps, method=method)[0].shape == images.shape
        assert affine.augment_images_and_peaks(gen, images, pk, vals,
                                               method=method)[0].shape == images.shape
        assert affine.augment_views_and_peaks(gen, images, pk, vals,
                                              method=method)[2].shape == (1, 1, 3, 3)
    for fn, args in ((affine.augment_pair, (images, maps)),
                     (affine.augment_images_and_peaks, (images, pk, vals)),
                     (affine.augment_views_and_peaks, (images, pk, vals))):
        with pytest.raises(ValueError, match="separable"):
            fn(torch.Generator(), *args, method="gather")


def test_sample_augment_params_statistics():
    """The draws cannot be JAX's; their distributions are
    (tensorflow/simple_data_generator.py:72-95)."""
    gen = torch.Generator().manual_seed(0)
    p = affine.sample_augment_params(gen, 20000, rotation_range=30.0, xy_shifts=10.0,
                                     zoom_range=(0.9, 1.1), shear_range=5.0)
    a, s = p.angle_deg.numpy(), p.scale.numpy()
    assert -30 <= a.min() < -29.5 and 29.5 < a.max() <= 30 and abs(a.mean()) < 0.5
    assert 0.9 <= s.min() and s.max() <= 1.1 and abs(s.mean() - 1.0) < 2e-3
    for sh in (p.shift_x.numpy(), p.shift_y.numpy()):
        assert -10 <= sh.min() and sh.max() <= 10 and abs(sh.std() - 20 / 12**0.5) < 0.1
    for f in (p.flip_h.numpy(), p.flip_v.numpy()):
        assert f.dtype == np.bool_ and abs(f.mean() - 0.5) < 0.02
    assert np.abs(p.shear_deg.numpy()).max() <= 5.0
    q = affine.sample_augment_params(torch.Generator().manual_seed(0), 100,
                                     do_horizontal_flip=False, do_vertical_flip=False)
    assert not q.flip_h.any() and not q.flip_v.any() and q.shear_deg is None


def test_augment_images_and_peaks_consistency(rng):
    """Targets rendered at the moved peaks agree with warping the rendered
    maps (same generator state, same transform); the image warps equal."""
    b, hw, k = 3, 48, 5
    pk = T(rng.uniform(12, 36, (b, k, 2)).astype(np.float32))
    vals = torch.ones((b, k))
    maps0 = gaussian.confmaps_from_peaks(pk, (hw, hw), 3.0)
    imgs = T(rng.random((b, hw, hw, 4)).astype(np.float32))
    kw = dict(rotation_range=25.0, xy_shifts=4.0, zoom_range=(0.9, 1.1))
    w_a, rendered = affine.augment_images_and_peaks(
        torch.Generator().manual_seed(3), imgs, pk, vals, sigma=3.0, **kw)
    w_b, warped = affine.augment_pair(torch.Generator().manual_seed(3), imgs, maps0, **kw)
    np.testing.assert_allclose(w_a.numpy(), w_b.numpy(), atol=1e-6)
    pr = peaks.find_peaks(rendered).numpy()
    pw = peaks.find_peaks(warped).numpy()
    inside = warped.amax(dim=(1, 2)).numpy() > 0.5
    assert inside.sum() >= 10
    assert np.median(np.linalg.norm(pr - pw, axis=-1)[inside]) <= 1.0


def test_augment_zero_vals_render_zero_maps(rng):
    pk = T(rng.uniform(5, 25, (2, 4, 2)).astype(np.float32))
    vals = torch.tensor([[1.0, 0, 1, 0], [0, 1, 0, 1]])
    _, maps = affine.augment_images_and_peaks(
        torch.Generator().manual_seed(0), torch.rand(2, 32, 32, 4), pk, vals,
        rotation_range=10.0, xy_shifts=2.0)
    top = maps.amax(dim=(1, 2))
    assert bool((top[vals == 0] == 0).all()) and bool((top[vals == 1] > 0.3).all())


def test_view_blocks_warped_by_their_own_matrix(rng):
    b, hw, v, cpv = 1, 32, 4, 2
    images = T(rng.random((b, hw, hw, v * cpv)).astype(np.float32))
    pk = T(rng.uniform(8, 24, (b, v * 2, 2)).astype(np.float32))
    warped, maps, mats = affine.augment_views_and_peaks(
        torch.Generator().manual_seed(3), images, pk, torch.ones(b, v * 2),
        num_views=v, rotation_range=25.0, xy_shifts=4.0, method="exact")
    assert mats.shape == (b, v, 3, 3) and maps.shape == (b, hw, hw, v * 2)
    assert not torch.allclose(mats[0, 0], mats[0, 1], atol=1e-3)
    for view in range(v):
        block = images[..., view * cpv:(view + 1) * cpv].numpy()
        want = _np(jaffine.affine_warp_batch(jnp.asarray(block),
                                             jnp.asarray(mats[:, view].numpy())))
        np.testing.assert_allclose(warped[..., view * cpv:(view + 1) * cpv].numpy(),
                                   want, atol=1e-5)


def test_augment_pair_clamps_cubic_targets(rng):
    maps = gaussian.confmaps_from_peaks(T(rng.uniform(8, 40, (4, 5, 2)).astype(np.float32)),
                                        (48, 48), 3.0)
    _, w3 = affine.augment_pair(torch.Generator().manual_seed(7), torch.rand(4, 48, 48, 2),
                                maps, rotation_range=30.0, xy_shifts=5.0, order=3)
    assert float(w3.min()) >= 0.0


@pytest.mark.parametrize("order", [1, 3])
def test_gather_warp_vs_jax_default_separable_at_192(rng, order):
    """The gap between the port's two warps at the production size: the
    gather (``method="exact"``) against the separable one, JAX's default
    (tests/test_torch_affine_separable.py holds it to JAX's), held to the
    tolerance of
    tests/test_ops_affine.py::test_separable_matches_exact_at_production_size
    (max 0.05, mean 1e-3). The separable passes run Catmull-Rom whatever
    the order, so at order 1 this is also bilinear against cubic."""
    pk = rng.uniform(30, 160, (2, 8, 2)).astype(np.float32)
    img = _np(jgaussian.confmaps_from_peaks(jnp.asarray(pk), (192, 192), 5.0))
    kw = dict(angle_deg=[37.0, -22.0], scale=[0.9, 1.1], shift_x=[6.0, -8.0],
              shift_y=[-5.0, 7.0], flip_h=[True, False])
    mats = _np(jaffine.make_affine_matrix(_params(jaffine, 2, **kw), 192, 192))
    sep = affine.affine_warp_separable_batch(T(img), T(mats), order,
                                             shear_limit=affine._shear_limit(30.0)).numpy()
    got = affine.affine_warp_batch(T(img), T(mats), order).numpy()
    d = np.abs(got - sep)
    print(f"gather vs separable at 192 px, order {order}: max {d.max():.2e}, "
          f"mean {d.mean():.2e}")
    assert d.max() < 0.05, d.max()
    assert d.mean() < 1e-3, d.mean()


# ---- training decodes, losses, reprojection --------------------------------------

def test_marginal_soft_argmax_pointwise_loss_and_l2_match_jax(rng):
    a = rng.random((3, 24, 20, 4)).astype(np.float32)
    b = rng.random((3, 24, 20, 4)).astype(np.float32)
    a[0, ..., 1] = 0.0  # an empty channel decodes to a finite point
    np.testing.assert_allclose(peaks.marginal_soft_argmax(T(a)).numpy(),
                               _np(jpeaks.marginal_soft_argmax(jnp.asarray(a))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(peaks.pointwise_loss(T(a), T(b))),
                               float(jpeaks.pointwise_loss(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    pk = rng.uniform(3, 18, (3, 4, 2)).astype(np.float32)
    g = _np(jgaussian.confmaps_from_peaks(jnp.asarray(pk), (24, 20), 2.0))
    for decode in ("argmax", "refined"):
        got = peaks.l2_distances(T(b), T(g), decode=decode).numpy()
        want = _np(jpeaks.l2_distances(jnp.asarray(b), jnp.asarray(g), decode=decode))
        assert got.shape == (3, 4)
        np.testing.assert_allclose(got, want, atol=1e-4)


def _cameras(rng):
    cams = []
    for yaw in (0.0, 1.6, 3.1, 4.7):
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        center = rot.T @ np.array([0.0, 0.0, -0.25])
        kmat = np.array([[3000.0, 0, 640], [0, 3000.0, 400], [0, 0, 1]])
        cams.append(kmat @ np.hstack([rot, -(rot @ center)[:, None]]))
    return np.stack(cams).astype(np.float32)


def test_reproject_and_reprojection_error_score_match_jax(rng):
    cams = _cameras(rng)
    pts3 = rng.uniform(-0.004, 0.004, (9, 3)).astype(np.float32)
    np.testing.assert_allclose(geometry.reproject(T(cams[0]), T(pts3)).numpy(),
                               _np(jgeometry.reproject(jnp.asarray(cams[0]), jnp.asarray(pts3))),
                               rtol=1e-5)
    crop = rng.integers(100, 400, (4, 2)).astype(np.float32)
    pts2 = rng.uniform(0, 192, (3, 4, 9, 2)).astype(np.float32)  # 3 options at once
    got = geometry.reprojection_error_score(T(pts2), T(crop), T(cams)).numpy()
    want = [float(jgeometry.reprojection_error_score(jnp.asarray(p), jnp.asarray(crop),
                                                     jnp.asarray(cams))) for p in pts2]
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-3)
