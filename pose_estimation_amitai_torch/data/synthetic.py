"""Synthetic dataset generator matching the H5 contract (PyTorch port).

A numpy copy of ``pose_estimation_amitai_tpu/data/synthetic.py`` (the port
imports nothing of the JAX package); tests/test_torch_data.py holds the two
equal. The reference trains from an HDF5 file with datasets ``box``,
``confmaps``, ``points_3D``, ``cropZone`` and ``cameras_dlt_array``
(reference loaders at pytorch/preprocessor.py:102-118, 56-62,
pytorch/Datagenerators.py:235). The real dataset is lab-internal, so this
generator produces the same shapes and dtypes with internally consistent
geometry (3D points that project into the crops through the DLT cameras).
"""

from __future__ import annotations

import numpy as np

from ..constants import IMAGE_SIZE, NUM_CAMERAS, SENSOR_HEIGHT
from .h5 import write_datasets


def _synthetic_cameras(rng: np.random.Generator) -> np.ndarray:
    """Four plausible K[R|t] cameras ringed around the origin, (4, 3, 4)."""
    cams = []
    for i in range(NUM_CAMERAS):
        f = 14000.0 + rng.uniform(-500, 500)
        K = np.array(
            [[f, 0.0, 400.0], [0.0, f, 400.0], [0.0, 0.0, 1.0]]
        )
        theta = i * np.pi / 2 + rng.uniform(-0.2, 0.2)
        phi = 0.5 + rng.uniform(-0.1, 0.1)
        Rz = np.array(
            [
                [np.cos(theta), -np.sin(theta), 0.0],
                [np.sin(theta), np.cos(theta), 0.0],
                [0.0, 0.0, 1.0],
            ]
        )
        Rx = np.array(
            [
                [1.0, 0.0, 0.0],
                [0.0, np.cos(phi), -np.sin(phi)],
                [0.0, np.sin(phi), np.cos(phi)],
            ]
        )
        R = Rx @ Rz
        t = np.array([[0.0], [0.0], [3.0]])
        cams.append(K @ np.hstack([R, t]))
    return np.stack(cams)


def _ellipse_mask(h, w, cy, cx, ry, rx, angle) -> np.ndarray:
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    ys = ys - cy
    xs = xs - cx
    ca, sa = np.cos(angle), np.sin(angle)
    u = ca * xs + sa * ys
    v = -sa * xs + ca * ys
    return ((u / rx) ** 2 + (v / ry) ** 2 <= 1.0).astype(np.float32)


def _gaussian(h, w, cy, cx, sigma=3.0) -> np.ndarray:
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    d2 = (ys - cy) ** 2 + (xs - cx) ** 2
    return np.exp(-d2 / (2.0 * sigma**2)).astype(np.float32)


def make_synthetic_arrays(
    num_frames: int = 16,
    num_points: int = 16,  # wing points total (half per wing) + 2 head/tail
    image_size: int = IMAGE_SIZE,
    num_time_channels: int = 3,
    sigma: float = 3.0,
    seed: int = 0,
    wing_spread: float = 0.004,  # half-extent of each wing's 3D point cloud
    feature_amp: float = 1.0,  # per-keypoint visual feature amplitude scale
    motion: str = "iid",  # "iid": independent pose per frame; "movie":
    # smooth wingbeat trajectory (consecutive frames correlate like real
    # high-speed video — the structure the reference's debug regime
    # actually trains on: 10 CONSECUTIVE movie frames, 50/50 split)
    stroke_period: float = 20.0,  # frames per wingbeat cycle ("movie")
    stroke_amp: float = 0.6,  # stroke half-amplitude, radians ("movie")
    layout: str = "cloud",  # "cloud": uniform random wing point cloud;
    # "outline": ordered landmarks along the wing's elliptical planform
    # boundary — keypoint identity is then geometric position along a
    # smooth curve, like the reference's real wing annotations (ordered
    # leading/trailing-edge points), instead of a ~3%-amplitude contrast
    # between overlapping speckles that no model can resolve quickly
) -> dict[str, np.ndarray]:
    """Build the five H5-contract arrays.

    Returns dict with H5-layout arrays (pre-transpose, matching what
    ``h5py.File(...)[k][:]`` yields for the real file after the loader's
    ``.T`` fixups — we produce the post-fixup canonical layouts directly and
    also provide transposed variants via :func:`write_synthetic_h5`):

    * box: (frames, cams, H, W, T+2) float32 in [0, 1]
    * confmaps: (frames, cams, H, W, num_points + 2)
    * points_3D: (frames, num_points + 2, 3)
    * cropZone: (frames, cams, 2) int [y, x]
    * cameras_dlt_array: (cams, 3, 4)
    """
    rng = np.random.default_rng(seed)
    h = w = image_size
    cams = _synthetic_cameras(rng)
    n_all = num_points + 2

    box = np.zeros((num_frames, NUM_CAMERAS, h, w, num_time_channels + 2), np.float32)
    confmaps = np.zeros((num_frames, NUM_CAMERAS, h, w, n_all), np.float32)
    points_3d = np.zeros((num_frames, n_all, 3), np.float32)
    cropzone = np.zeros((num_frames, NUM_CAMERAS, 2), np.int32)

    half = num_points // 2

    def _outline_shape(side):
        """Ordered landmarks on the wing planform boundary (local frame).

        The wing is an elongated ellipse extending from the hinge (y=0)
        outward to ``2*wing_spread``; landmark p sits at boundary angle
        2*pi*p/half, so adjacent indices are spatial neighbours — the
        identity structure real annotated wings have. A small out-of-plane
        z term keeps the stroke rotation visible and the points
        non-coplanar. Returned centred like the cloud layout (the caller
        adds the [0, side*wing_spread, 0] offset).
        """
        phi = 2.0 * np.pi * np.arange(half) / half
        return np.stack(
            [
                0.4 * wing_spread * np.cos(phi),
                side * wing_spread * np.sin(phi),
                0.15 * wing_spread * np.sin(2.0 * phi),
            ],
            axis=1,
        )

    # "movie" mode: one fly with a FIXED wing shape whose pose evolves
    # smoothly — body drifts linearly, each wing rotates about its hinge
    # (the body x-axis) with a sinusoidal stroke. Frame-to-frame keypoint
    # motion is then a few px, matching consecutive high-speed-video frames.
    # These draws are gated on the mode so iid-mode callers keep a stable
    # RNG stream per seed (consuming them unconditionally shifts every
    # downstream draw and changes the default dataset under callers' feet).
    if motion == "movie":
        body0 = rng.uniform(-0.002, 0.002, 3)
        drift = rng.uniform(-0.0002, 0.0002, 3)
        if layout == "outline":
            wing_shape = [_outline_shape(side) for side in (-1, 1)]
        else:
            wing_shape = [
                rng.uniform(-wing_spread, wing_spread, (half, 3))
                for _ in range(2)
            ]
        stroke_phase = rng.uniform(0, 2 * np.pi)
    for f in range(num_frames):
        if motion == "movie":
            body = body0 + drift * f
            theta = stroke_amp * np.sin(
                2 * np.pi * f / stroke_period + stroke_phase
            )
            wing_pts = []
            for si, side in enumerate((-1, 1)):
                hinge = body + np.array([0.0, side * 0.002, 0.0])
                local = wing_shape[si] + np.array(
                    [0.0, side * wing_spread, 0.0]
                )
                c_, s_ = np.cos(theta), np.sin(theta)
                rot = np.stack(
                    [
                        local[:, 0],
                        local[:, 1] * c_ - local[:, 2] * s_,
                        local[:, 1] * s_ + local[:, 2] * c_,
                    ],
                    axis=1,
                )
                wing_pts.append(hinge + rot)
        else:
            # a fly: body at origin-ish, two wings as 3D point clusters,
            # an independent random pose per frame
            body = rng.uniform(-0.002, 0.002, 3)
            wing_pts = []
            for side in (-1, 1):
                base = body + np.array(
                    [0.0, side * (0.002 + wing_spread), 0.0]
                )
                if layout == "outline":
                    # fixed planform at an independent random stroke angle
                    # per frame per wing
                    th = rng.uniform(-stroke_amp, stroke_amp)
                    sh = _outline_shape(side)
                    c_, s_ = np.cos(th), np.sin(th)
                    pts = base + np.stack(
                        [
                            sh[:, 0],
                            sh[:, 1] * c_ - sh[:, 2] * s_,
                            sh[:, 1] * s_ + sh[:, 2] * c_,
                        ],
                        axis=1,
                    )
                else:
                    pts = base + rng.uniform(
                        -wing_spread, wing_spread, (half, 3)
                    )
                wing_pts.append(pts)
        head = body + np.array([0.008, 0.0, 0.0])
        tail = body - np.array([0.008, 0.0, 0.0])
        pts3d = np.concatenate([wing_pts[0], wing_pts[1], [head], [tail]])
        points_3d[f] = pts3d

        ph = np.concatenate([pts3d, np.ones((n_all, 1))], axis=1)
        for c in range(NUM_CAMERAS):
            proj = ph @ cams[c].T
            xy = proj[:, :2] / proj[:, 2:3]  # full-sensor coords
            # crop centred on the fly
            cx = int(np.clip(np.mean(xy[:, 0]) - w / 2, 0, 2 * SENSOR_HEIGHT))
            y_sensor = np.mean(xy[:, 1])
            # crop-local y derives from: y_local = (SENSOR_HEIGHT+1-y) - y_crop
            y_crop = int(np.clip(SENSOR_HEIGHT + 1 - y_sensor - h / 2, 0, SENSOR_HEIGHT))
            cropzone[f, c] = (y_crop, cx)
            x_local = xy[:, 0] - cx
            y_local = (SENSOR_HEIGHT + 1 - xy[:, 1]) - y_crop

            for p in range(n_all):
                confmaps[f, c, :, :, p] = _gaussian(
                    h, w, y_local[p], x_local[p], sigma
                )
            # time channels: blurry fly blob at 3 nearby times, plus sharp
            # per-keypoint features so the frames actually carry the
            # information needed to localise keypoints (real frames show
            # wing veins/edges at the annotated points — without this the
            # regression task would be unlearnable by construction)
            body_y = np.mean(y_local)
            body_x = np.mean(x_local)
            # wing ellipse params (masks + outline-mode membranes)
            wing_ell = []
            for wi in range(2):
                sl = slice(wi * half, (wi + 1) * half)
                wy, wx = np.mean(y_local[sl]), np.mean(x_local[sl])
                ry = max(np.ptp(y_local[sl]) / 2 + 8, 10)
                rx = max(np.ptp(x_local[sl]) / 2 + 8, 10)
                if motion == "movie" or layout == "outline":
                    # smooth mask orientation: principal axis of the
                    # projected wing points (a per-frame random angle would
                    # make consecutive movie frames' masks jump)
                    dy = y_local[sl] - wy
                    dx = x_local[sl] - wx
                    ang = 0.5 * np.arctan2(
                        2.0 * float(np.sum(dx * dy)),
                        float(np.sum(dx * dx) - np.sum(dy * dy)),
                    )
                else:
                    ang = rng.uniform(0, np.pi)
                wing_ell.append((wy, wx, ry, rx, ang))
            for t in range(num_time_channels):
                jitter = (t - num_time_channels // 2) * 1.5
                blob = 0.5 * _gaussian(h, w, body_y + jitter, body_x + jitter, 14.0)
                for p in range(n_all):
                    # distinct per-keypoint intensity + size: real wing
                    # features are visually distinguishable; identical dots
                    # would make keypoint identity unlearnable
                    if layout == "outline":
                        # cycle the amplitude ramp with a stride COPRIME to
                        # n_all (7 unless 7 | n_all, e.g. n_all=14 would
                        # collapse to 2 levels) so spatially ADJACENT
                        # boundary landmarks get maximally different
                        # intensities — neighbour identity is the error
                        # mode that costs decode px
                        import math

                        stride = next(
                            s for s in (7, 9, 11, 13, 3, 1)
                            if math.gcd(s, n_all) == 1
                        )
                        amp = (0.45 + 0.5 * ((p * stride) % n_all + 1)
                               / n_all) * feature_amp
                    else:
                        amp = (0.45 + 0.5 * (p + 1) / n_all) * feature_amp
                    sig = 1.2 + 0.8 * (p % 4) / 3.0
                    blob += amp * _gaussian(
                        h, w, y_local[p] + jitter * 0.3,
                        x_local[p] + jitter * 0.3, sig,
                    )
                box[f, c, :, :, t] = np.clip(blob, 0, 1)
            # wing masks: ellipses covering each wing's peaks; outline
            # wings are elongated, so the fitted ellipse alone under-covers
            # the boundary landmarks — union in a disk around every
            # landmark (real segmentation masks cover the annotated points
            # by construction; split_per_wing pairing relies on it)
            for wi in range(2):
                wy, wx, ry, rx, ang = wing_ell[wi]
                m = _ellipse_mask(h, w, wy, wx, ry, rx, ang)
                if layout == "outline":
                    sl = slice(wi * half, (wi + 1) * half)
                    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
                    for py, px in zip(y_local[sl], x_local[sl]):
                        m = np.maximum(
                            m,
                            ((ys - py) ** 2 + (xs - px) ** 2
                             <= 12.0**2).astype(np.float32),
                        )
                box[f, c, :, :, num_time_channels + wi] = m

    return {
        "box": box,
        "confmaps": confmaps,
        "points_3D": points_3d,
        "cropZone": cropzone,
        "cameras_dlt_array": cams.astype(np.float32),
    }


def write_synthetic_h5(
    path: str,
    num_frames: int = 16,
    num_points: int = 16,
    seed: int = 0,
    h5_layout: str = "transposed",
    **kw,
) -> str:
    """Write a synthetic dataset to ``path`` in the reference's H5 layout.

    ``h5_layout="transposed"`` (default) stores the fully reversed arrays
    the real MATLAB-exported files carry (un-done by the loader's contract
    canonicalisation; reference dialect pytorch/preprocessor.py:110-118,
    ``cameras_dlt_array[:].T`` at :54, ``points_3D`` permute at :60-62);
    ``h5_layout="canonical"`` stores the post-fixup layouts directly — the
    loader accepts both. The file is written by the port's own writer
    (data/h5.py), as ``h5py``'s defaults would write it. Remaining ``**kw``
    (including the *wing* ``layout`` — "cloud"/"outline") pass through to
    :func:`make_synthetic_arrays`.
    """
    arrs = make_synthetic_arrays(num_frames, num_points, seed=seed, **kw)
    transposed = h5_layout == "transposed"
    return write_datasets(path, {
        "box": arrs["box"].T if transposed else arrs["box"],
        "confmaps": arrs["confmaps"].T if transposed else arrs["confmaps"],
        # reference dialect: raw (3, frames, pts); canonical (frames, pts, 3)
        "points_3D": np.transpose(arrs["points_3D"], (2, 0, 1))
        if transposed else arrs["points_3D"],
        "cropZone": arrs["cropZone"],
        # loader: h5["cameras_dlt_array"][:].T -> (4,3,4); store (4,3,4).T
        "cameras_dlt_array": arrs["cameras_dlt_array"].T,
    })
