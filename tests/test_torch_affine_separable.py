"""The port's separable warp (ops/affine.py) against the JAX package's on the
same numpy-seeded inputs (CPU): the two row primitives at orders 1 and 3
with the origins and widths the warp passes them, the whole warp on fixed
matrices at 48 px and 192 px (float32 within 1e-5; bf16 within JAX's own
bf16-against-float32 difference), the canvas-bucket rules, the bucket
draws, the bucket index under a row share, and the warp each step takes at
``Config()``.

JAX runs jitted, as its train step runs the warp: one function per shape,
``affine_warp_separable_batch`` with each bucket's explicit ``shear_limit``
(never the bucketed ``augment_*``, which compiles three branches)."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.models import build_model
from pose_estimation_amitai_torch.ops import affine, draws
from pose_estimation_amitai_torch.train import loop, selfsup
from pose_estimation_amitai_tpu.ops import affine as jaffine

from test_torch_resnet import one_thread  # noqa: F401 (a fixture)

T = torch.from_numpy
ATOL = 1e-5  # float32, port against JAX


@pytest.fixture(autouse=True)
def _one_thread_here(one_thread):
    """Every case of this file on one intra-op thread (test_torch_resnet.py
    ``one_thread``: workers of the parallel run share the cores)."""


def _np(x) -> np.ndarray:
    return np.array(x)


def _mats(hw: int, cases: dict) -> np.ndarray:
    """(len(cases), 3, 3) forward matrices from JAX's ``make_affine_matrix``,
    one sample per case (fields missing from a case take the identity)."""
    b = len(cases)
    fields = dict(angle_deg=0.0, scale=1.0, shift_x=0.0, shift_y=0.0,
                  flip_h=False, flip_v=False)
    cols = {f: np.array([c.get(f, d) for c in cases.values()],
                        np.bool_ if isinstance(d, bool) else np.float32)
            for f, d in fields.items()}
    params = jaffine.AugmentParams(*[jnp.asarray(cols[f]) for f in fields])
    return _np(jaffine.make_affine_matrix(params, hw, hw)).reshape(b, 3, 3)


@jax.jit
def _jax_inv(m):
    return jnp.linalg.inv(m)


_JAX_WARPS = {}


def _jax_warp(images: np.ndarray, mats: np.ndarray, order: int, limit: float):
    """JAX's separable warp, jitted once per (shape, dtype, order, limit)."""
    key = (images.shape, str(images.dtype), order, limit)
    if key not in _JAX_WARPS:
        _JAX_WARPS[key] = jax.jit(lambda i, m: jaffine.affine_warp_separable_batch(
            i, m, order, shear_limit=limit))
    return _JAX_WARPS[key](images, jnp.asarray(mats))


# ---- the row primitives -------------------------------------------------------

HW, E = 48, 26  # E: the canvas extension of a 48-px warp at shear_limit 1


@pytest.fixture(scope="module")
def row_inputs():
    rng = np.random.default_rng(0)
    img = rng.random((2, HW, HW, 3)).astype(np.float32)
    wide = rng.random((2, HW, HW + 2 * E, 3)).astype(np.float32)
    # shears up to and past the largest offset the canvas covers (E)
    off_x = rng.uniform(-E - 20, E + 20, (2, HW)).astype(np.float32)
    off_x[0, :4] = [E + 1.5, -E - 3.25, 60.0, -47.0]
    off_y = rng.uniform(-E, E, (2, HW)).astype(np.float32)
    return img, wide, off_x, off_y


@pytest.fixture(scope="module")
def row_primitives(row_inputs):
    """{order: (port, JAX)} outputs of the four primitive calls the warp
    makes: shift onto the wide canvas, resample off it, resample onto it,
    shift off it."""
    img, wide, off_x, off_y = row_inputs
    stride = np.float32([0.93, -1.1])
    offset_x = np.float32([E + 3.4, E + 50.2])  # the canvas origin folded in
    offset_y = np.float32([-E + 1.7, 40.3])
    out = {}
    for order in (1, 3):
        def calls(mod, conv):
            return [
                mod._row_fractional_shift(conv(img), conv(off_x), order,
                                          out_width=HW + 2 * E, out_origin=-E, max_offset=E),
                mod._row_resample(conv(wide), conv(stride), conv(offset_x), order,
                                  out_width=HW),
                mod._row_resample(conv(img), conv(stride), conv(offset_y), order,
                                  out_width=HW + 2 * E),
                mod._row_fractional_shift(conv(wide), conv(off_y), order,
                                          out_width=HW, out_origin=E, max_offset=E),
            ]
        want = jax.jit(lambda: calls(jaffine, jnp.asarray))()
        got = calls(affine, T)
        out[order] = ([g.numpy() for g in got], [_np(w) for w in want])
    return out


@pytest.mark.parametrize("call", ["shift_onto_canvas", "resample_off_canvas",
                                  "resample_onto_canvas", "shift_off_canvas"])
@pytest.mark.parametrize("order", [1, 3])
def test_row_primitives_match_jax(row_primitives, order, call):
    i = ["shift_onto_canvas", "resample_off_canvas", "resample_onto_canvas",
         "shift_off_canvas"].index(call)
    got, want = row_primitives[order][0][i], row_primitives[order][1][i]
    assert got.shape == want.shape and np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_row_shift_past_max_offset_loses_its_taps_as_jax(row_inputs, row_primitives):
    """An offset past the canvas's coverage (60 and -47 px against 26)
    reads only the taps JAX's clipped coarse digit reaches: here none."""
    got = row_primitives[3][0][0]
    np.testing.assert_array_equal(got[0, 2], 0.0)
    np.testing.assert_array_equal(got[0, 3], 0.0)
    assert np.abs(got[0, 0]).max() > 0.5


def test_inverse_is_jaxs_to_the_bit(rng):
    """The warp's 3x3 inverse equals ``jnp.linalg.inv`` bit for bit, where
    ``torch.linalg.inv`` is a few ulps off."""
    b = 256
    cases = {i: dict(angle_deg=a, scale=s, shift_x=x, shift_y=y, flip_h=bool(fh))
             for i, (a, s, x, y, fh) in enumerate(zip(
                 rng.uniform(-180, 180, b), rng.uniform(0.8, 1.2, b),
                 rng.uniform(-10, 10, b), rng.uniform(-10, 10, b), rng.random(b) < 0.5))}
    mats = _mats(192, cases)
    np.testing.assert_array_equal(affine._inverse(T(mats)).numpy(),
                                  _np(_jax_inv(jnp.asarray(mats))))


# ---- the whole warp ---------------------------------------------------------------

# Exactly +-45 degrees is avoided: there |a01| == |a11|, and which of the two
# a float rounds larger (so whether the rot90 branch is taken) can differ
# between two correct computations.
CASES = {
    "identity": {},
    "flip_h": dict(flip_h=True),
    "flip_v": dict(flip_v=True),
    "integer_shift": dict(shift_x=3.0, shift_y=-2.0),
    "rot90": dict(angle_deg=90.0),
    "rot37_zoom09_flip": dict(angle_deg=37.0, scale=0.9, shift_x=2.0, flip_h=True),
    "rot-37_zoom11": dict(angle_deg=-37.0, scale=1.1, shift_y=1.5),
    "rot22_zoom11_flip": dict(angle_deg=22.0, scale=1.1, shift_x=-3.5, flip_v=True),
    "quadrant180": dict(angle_deg=180.0 + 13.0, shift_x=1.0),
}


@pytest.fixture(scope="module")
def warps48():
    """{order: (port, JAX)} float32 warps of every case at 48 px, and the
    bf16 ones at order 1 with JAX's float32 beside them."""
    img = np.random.default_rng(1).random((len(CASES), 48, 48, 3)).astype(np.float32)
    mats = _mats(48, CASES)
    out = {}
    for order in (1, 3):
        got = affine.affine_warp_separable_batch(T(img), T(mats), order).numpy()
        out[order] = (got, _np(_jax_warp(img, mats, order, 1.0)))
    img16 = jnp.asarray(img, jnp.bfloat16)
    got16 = affine.affine_warp_separable_batch(T(img).bfloat16(), T(mats), 1)
    out["bf16"] = (got16.float().numpy(),
                   _np(_jax_warp(img16, mats, 1, 1.0).astype(jnp.float32)), out[1][1])
    return img, out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("order", [1, 3])
def test_separable_warp_matches_jax_at_48(warps48, order, case):
    img, out = warps48
    i = list(CASES).index(case)
    got, want = out[order][0][i], out[order][1][i]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if case == "identity":
        np.testing.assert_allclose(got, img[i], atol=ATOL)
    if case in ("flip_h", "rot90"):  # the kernel is a delta at integer offsets
        turned = img[i][:, ::-1] if case == "flip_h" else np.rot90(img[i], k=1)
        np.testing.assert_allclose(got, turned, atol=ATOL)


def test_separable_warp_bf16_within_jaxs_own_bf16_gap(warps48):
    """bf16 rounds each of the four passes. The port's bf16 warp lies within
    the gap between JAX's bf16 and float32 warps on the same inputs (max
    0.0156 here, two bf16 ulps at 1); a first pass rounded the other way
    moves a pixel by at most that much."""
    _, out = warps48
    got16, jax16, jax32 = out["bf16"]
    own = float(np.abs(jax16 - jax32).max())
    gap = float(np.abs(got16 - jax16).max())
    print(f"bf16: port vs JAX {gap:.3g}, JAX bf16 vs float32 {own:.3g}")
    assert 0 < own <= 0.02
    assert gap <= own, (gap, own)
    assert float(np.abs(got16 - jax32).max()) <= own


@pytest.mark.parametrize("order", [1, 3])
def test_separable_warp_matches_jax_at_192(order):
    cases = {k: CASES[k] for k in ("rot37_zoom09_flip", "quadrant180")}
    img = np.random.default_rng(2).random((2, 192, 192, 2)).astype(np.float32)
    mats = _mats(192, cases)
    limit = jaffine._shear_limit(30.0)
    got = affine.affine_warp_separable_batch(T(img), T(mats), order, shear_limit=limit)
    np.testing.assert_allclose(got.numpy(), _np(_jax_warp(img, mats, order, limit)),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("order", [1, 3])
def test_non_square_takes_the_gather_warp(order):
    """As JAX's, the separable warp of a non-square frame is the gather warp
    at the given order (tests/test_torch_ops_train.py holds that one to
    JAX's at this shape)."""
    img = np.random.default_rng(3).random((2, 40, 48, 3)).astype(np.float32)
    mats = affine.make_affine_matrix(affine.AugmentParams(
        torch.tensor([13.0, -25.0]), torch.tensor([1.0, 0.9]), torch.tensor([2.0, 0.0]),
        torch.tensor([0.0, 1.5]), torch.tensor([False, True]), torch.tensor([True, False])),
        40, 48)
    got = affine.affine_warp_separable_batch(T(img), mats, order)
    assert got.shape == (2, 40, 48, 3) and float(got.abs().max()) > 0.5
    np.testing.assert_array_equal(got.numpy(),
                                  affine.affine_warp_batch(T(img), mats, order).numpy())


# ---- the bucket rules and draws -------------------------------------------------

@pytest.mark.parametrize("rotation, shear", [
    (15.0, 0.0), (20.0, 0.0), (30.0, 0.0), (45.0, 0.0), (60.0, 0.0), (180.0, 0.0),
    (200.0, 0.0), (30.0, 5.0)])
def test_rotation_buckets_and_shear_limit_equal_jax(rotation, shear):
    assert affine.rotation_buckets(rotation, shear) == jaffine.rotation_buckets(rotation, shear)
    assert affine._shear_limit(rotation, shear) == jaffine._shear_limit(rotation, shear)
    for lo, hi, _ in affine.rotation_buckets(rotation, shear) or []:
        assert affine._shear_limit(hi, shear) == jaffine._shear_limit(hi, shear)
        assert affine._shear_limit(lo, shear) == jaffine._shear_limit(lo, shear)


@pytest.mark.parametrize("quadrants", [False, True])
def test_bucket_draws_statistics(quadrants):
    """Magnitude uniform in [low, high] with a random sign, and with
    ``quadrants`` a uniform multiple of 90 degrees on top."""
    n = 20000
    p = affine.sample_augment_params(torch.Generator().manual_seed(0), n,
                                     rotation_range=30.0, rotation_low=20.0,
                                     quadrants=quadrants)
    a = p.angle_deg.numpy().astype(np.float64)
    quad = np.round(a / 90.0) if quadrants else np.zeros(n)
    resid = a - 90.0 * quad
    if quadrants:  # residual in +-[20, 30]: the nearest multiple of 90 is its quadrant
        np.testing.assert_array_equal(np.unique(quad % 4), [0, 1, 2, 3])
        assert np.abs(np.bincount((quad % 4).astype(int)) / n - 0.25).max() < 0.02
    mag = np.abs(resid)
    assert 20.0 <= mag.min() < 20.05 and 29.95 < mag.max() <= 30.0
    assert abs(mag.mean() - 25.0) < 0.1
    assert abs((resid > 0).mean() - 0.5) < 0.02
    assert p.shear_deg is None and p.scale.shape == (n,)


def test_scalar_draw_ignores_the_row_share():
    whole = draws.scalar_randint(3, torch.Generator().manual_seed(5), "cpu")
    for index in (0, 1):
        with draws.row_share(index, 2):
            assert draws.scalar_randint(3, torch.Generator().manual_seed(5), "cpu") == whole


def test_bucket_index_under_a_row_share(monkeypatch):
    """The two halves of a bucketed ``augment_views_and_peaks`` at 96 px,
    each under its row share, concatenate to the whole batch's result:
    the same bucket (shear limit), matrices, warped frames and maps."""
    limits = []
    real = affine.affine_warp_separable_batch

    def spy(images, mats, order=1, shear_limit=1.0):
        limits.append(shear_limit)
        return real(images, mats, order, shear_limit=shear_limit)

    monkeypatch.setattr(affine, "affine_warp_separable_batch", spy)
    rng = np.random.default_rng(4)
    b, hw, k = 4, 96, 3
    images = T(rng.random((b, hw, hw, 2)).astype(np.float32))
    pk = T(rng.uniform(20, 76, (b, k, 2)).astype(np.float32))
    vals = torch.ones((b, k))
    buckets = {affine._shear_limit(hi) for _, hi, _ in affine.rotation_buckets(30.0)}
    seen = set()
    for seed in range(6):
        limits.clear()
        whole = affine.augment_views_and_peaks(torch.Generator().manual_seed(seed), images,
                                               pk, vals, rotation_range=30.0, xy_shifts=4.0)
        halves = []
        for index in (0, 1):
            rows = slice(index * b // 2, (index + 1) * b // 2)
            with draws.row_share(index, 2):
                halves.append(affine.augment_views_and_peaks(
                    torch.Generator().manual_seed(seed), images[rows], pk[rows], vals[rows],
                    rotation_range=30.0, xy_shifts=4.0))
        assert len(set(limits)) == 1 and limits[0] in buckets, limits
        seen.add(limits[0])
        for w, h0, h1 in zip(whole, *halves):
            np.testing.assert_allclose(torch.cat([h0, h1]).numpy(), w.numpy(),
                                       atol=1e-6, rtol=0)
    assert len(seen) >= 2, seen  # the seeds drew more than one bucket


# ---- the warp each step takes at Config() ----------------------------------------

class _Stop(Exception):
    pass


def _first_warp(monkeypatch, run) -> tuple:
    """(images, matrices, order, shear_limit, warped) of the first separable
    warp ``run()`` makes; the run stops there."""
    calls = []
    real = affine.affine_warp_separable_batch

    def spy(images, mats, order=1, shear_limit=1.0):
        calls.append((images, mats, order, shear_limit,
                      real(images, mats, order, shear_limit=shear_limit)))
        raise _Stop

    monkeypatch.setattr(affine, "affine_warp_separable_batch", spy)
    with pytest.raises(_Stop):
        run()
    return calls[0]


def _magnitudes(mats: torch.Tensor) -> np.ndarray:
    """|angle| in degrees of forward matrices of a draw within +-45: the
    linear part is s R(angle) diag(+-1, +-1)."""
    m = mats.reshape(-1, 3, 3).double().numpy()
    return np.degrees(np.arctan2(np.abs(m[:, 0, 1]), np.abs(m[:, 0, 0])))


@pytest.mark.parametrize("step", ["train", "sharded", "selfsup"])
def test_config_steps_warp_by_the_bucketed_separable_warp(monkeypatch, step):
    """At ``Config()`` (rotation 30, 192 px, order 1, bf16 compute) the train
    step's microbatch (frames in bf16, targets re-rendered at the peaks),
    the data-parallel step's (stored maps warped beside the frames) and
    the self-supervised step's preparation warp by the separable warp on
    one bucket's canvas, every angle in that bucket; the train step's warp
    equals JAX's on the same frames and matrices."""
    cfg = Config()
    rng = np.random.default_rng(6)
    n, k = 8, 18
    gen = torch.Generator().manual_seed(7)
    box = rng.random((n, 192, 192, 5 if step == "selfsup" else 4)).astype(np.float32)
    if step == "selfsup":
        box[..., 3:] = box[..., 3:] > 0.5  # wing masks
        run = lambda: selfsup.make_prepare(cfg)(gen, T(box))  # noqa: E731
    else:
        with torch.device("meta"):
            model = build_model(cfg, (192, 192, 4), k)
        data = {"box": T(box)}
        if step == "train":
            data["peaks"] = T(rng.uniform(20, 170, (n, k, 2)).astype(np.float32))
            data["peak_vals"] = torch.ones((n, k))
        else:
            data["confmaps"] = T(rng.random((n, 192, 192, k)).astype(np.float32))
        micro = loop._microbatch_fn(model, cfg, stored_targets=step == "sharded")
        run = lambda: micro({}, {}, data, np.arange(n), gen)  # noqa: E731
    images, mats, order, limit, warped = _first_warp(monkeypatch, run)
    buckets = {affine._shear_limit(hi): (lo, hi) for lo, hi, _ in affine.rotation_buckets(30.0)}
    assert limit in buckets and order == 1
    lo, hi = buckets[limit]
    mag = _magnitudes(mats)
    assert ((mag >= lo - 1e-3) & (mag <= hi + 1e-3)).all(), (lo, hi, mag)
    want_dtype = torch.bfloat16 if step == "train" else torch.float32
    assert images.dtype == warped.dtype == want_dtype
    if step == "train":
        want = _jax_warp(jnp.asarray(images.float().numpy(), jnp.bfloat16), mats.numpy(),
                         order, limit)
        d = np.abs(warped.float().numpy() - _np(want.astype(jnp.float32)))
        assert d.max() <= 0.02, d.max()  # the bf16 bound above
    assert math.isfinite(float(warped.float().abs().max()))
