"""Batched inference: frames -> heatmaps -> keypoints -> 3D (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/infer.py`` for the flagship
per-wing slice:

* ``Predictor`` — chunked forward (tail zero-padded, padded rows dropped)
  and peak decode on the device, over one of two routes: ``"fused"``, the
  hand-written Hopper kernels (models/fast_infer.py), or ``"module"``, the
  ``nn.Module`` forward (the port's counterpart of JAX's ``"flax"`` route);
* ``predict_movie`` — keeps up to ``prefetch`` chunks in flight;
* ``lift_to_3d`` — decoded per-camera peaks + cropZone + DLT cameras ->
  multi-view triangulated 3D points.

Public arrays keep the JAX contracts: NHWC frames (N, H, W, C) in, numpy
(N, 3, K) [x, y, val] peaks (and (N, H, W, K) maps) out.
"""

from __future__ import annotations

import numpy as np
import torch

from . import weights
from .config import Config
from .models import build_model
from .models.cnn import BasicNet
from .models.fast_infer import basicnet_apply_fused, kernel_params
from .ops import geometry, peaks

DECODES = ("argmax", "soft", "refined")


class Predictor:
    """Chunked heatmap inference + peak decode for one model on one device."""

    def __init__(
        self,
        cfg: Config,
        params,
        image_shape: tuple[int, int, int],
        num_output_channels: int,
        *,
        device: torch.device | str,
        chunk_size: int = 256,
        return_heatmaps: bool = False,
        use_fused: bool = False,
        use_quantized: bool = False,
        decode: str = "argmax",
        mesh=None,
        batch_stats=None,
        cameras=None,
    ):
        """``params``: a flax-layout params tree (nested dicts of arrays),
        bridged by :mod:`..weights`. ``device``: where the model runs; there
        is no default. ``use_fused``: serve the torch-flavour ``BasicNet``
        with 3x3 kernels at dilation 2 through the fused kernels
        (``serving_path == "fused"``; ``model`` stays None); otherwise,
        and for other models, the ``nn.Module`` forward (``"module"``). ``decode``: 'argmax' (tf_find_peaks
        parity), 'soft' (soft-argmax, vals from the map max) or 'refined'
        (sub-pixel log-parabola)."""
        if use_quantized:
            raise NotImplementedError(
                "int8 serving (use_quantized) is ROADMAP Queue A item 5")
        if mesh is not None:
            raise NotImplementedError(
                "sharded serving (mesh) is ROADMAP Queue A item 14")
        if cameras is not None:
            raise NotImplementedError(
                "camera-matrix models (cameras) are ROADMAP Queue A item 10")
        if batch_stats:
            raise NotImplementedError(
                "BatchNorm model families (batch_stats) are ROADMAP Queue A "
                "item 10")
        if decode not in DECODES:
            raise ValueError(f"decode={decode!r}; expected one of {DECODES}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size={chunk_size} must be >= 1")
        self.cfg = cfg
        self.device = torch.device(device)
        self.chunk_size = chunk_size
        self.return_heatmaps = return_heatmaps
        self.decode = decode
        self.num_output_channels = num_output_channels
        with torch.device("meta"):  # the geometry only; no weights yet
            model = build_model(cfg, image_shape, num_output_channels)
        # the fused kernels serve the flagship geometry (kernel 3, dilation
        # 2), as JAX's fused route does; other BasicNet configs use the module
        fused_ok = (
            use_fused and type(model) is BasicNet and model.flavor == "torch"
            and model.kernel_size == 3 and model.dilation == 2
        )
        self.serving_path = "fused" if fused_ok else "module"
        self.model: BasicNet | None = None  # the module route's nn.Module
        self._kparams = None
        if fused_ok:
            self._kparams = kernel_params(params, model.dtype, self.device)
        else:
            self.model = model.to_empty(device=self.device).eval()
            self.model.load_state_dict(weights.basicnet_state_dict(params))
            if self.device.type == "cuda":
                # NHWC frames permute to channels-last NCHW views; keep the
                # weights in the same format so cuDNN needs no transposes
                self.model.to(memory_format=torch.channels_last)

    @classmethod
    def from_checkpoint(
        cls,
        cfg: Config | str,
        checkpoint_path: str,
        image_shape: tuple[int, int, int] = (192, 192, 4),
        num_output_channels: int = 18,
        **kw,
    ) -> "Predictor":
        """Build from a flax msgpack params snapshot or full checkpoint
        (``weights.load_flax_checkpoint``; no jax). ``device`` is required
        as for the constructor."""
        if isinstance(cfg, str):
            cfg = Config.from_json(cfg)
        params, batch_stats = weights.load_flax_checkpoint(checkpoint_path)
        kw.setdefault("batch_stats", batch_stats)
        return cls(cfg, params, image_shape, num_output_channels, **kw)

    # ------------------------------------------------------------------
    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) frames on the device -> (B, H, W, K) float32 maps
        over this predictor's serving route."""
        with torch.inference_mode():
            if self._kparams is not None:
                return basicnet_apply_fused(self._kparams, frames)
            return self.model(frames)

    def _run(self, frames: torch.Tensor):
        maps = self.forward(frames)
        with torch.inference_mode():
            if self.decode == "soft":
                xy = peaks.find_peaks_soft_argmax(maps)  # (B, K, 2)
                vals = maps.amax(dim=(1, 2))
                pts = torch.cat([xy.transpose(1, 2), vals[:, None, :]], dim=1)
            elif self.decode == "refined":
                pts = peaks.find_peaks_refined(maps)
            else:
                pts = peaks.find_peaks_with_vals(maps)
        if self.return_heatmaps:
            return maps, pts
        return pts

    def _stage(self, chunk) -> torch.Tensor:
        """One chunk of frames on the device, zero-padded to chunk_size."""
        t = torch.as_tensor(chunk).to(self.device, non_blocking=True)
        pad = self.chunk_size - t.shape[0]
        if pad:
            t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
        return t

    def __call__(self, frames):
        """Decode keypoints for (N, H, W, C) frames (numpy or tensor); N
        arbitrary.

        Returns (N, 3, K) [x, y, val] float32 numpy (plus (N, H, W, K) maps
        first if ``return_heatmaps``).
        """
        n = frames.shape[0]
        cs = self.chunk_size
        outs, maps = [], []
        for i in range(0, n, cs):
            keep = min(cs, n - i)
            res = self._run(self._stage(frames[i : i + cs]))
            if self.return_heatmaps:
                m, p = res
                maps.append(m[:keep].cpu().numpy())
                outs.append(p[:keep].cpu().numpy())
            else:
                outs.append(res[:keep].cpu().numpy())
        pts = np.concatenate(outs)
        if self.return_heatmaps:
            return np.concatenate(maps), pts
        return pts

    def predict_movie(self, frames, prefetch: int = 4) -> np.ndarray:
        """Throughput-oriented decode of a whole movie.

        Keeps at most ``prefetch`` chunks in flight: the device queue runs
        chunk i + prefetch while the host waits for chunk i's small peak
        output, and device memory stays bounded at ``prefetch`` chunks
        whatever the movie's length. The ragged tail goes through
        ``__call__``.
        """
        if self.return_heatmaps:
            raise ValueError("predict_movie decodes peaks only")
        n = frames.shape[0]
        cs = self.chunk_size
        n_full = n // cs
        out: list[np.ndarray] = []
        in_flight: list[torch.Tensor] = []
        for i in range(n_full):
            in_flight.append(self._run(self._stage(frames[i * cs : (i + 1) * cs])))
            if len(in_flight) >= prefetch:
                out.append(in_flight.pop(0).cpu().numpy())
        out.extend(r.cpu().numpy() for r in in_flight)
        if n_full * cs < n:
            out.append(self(frames[n_full * cs :]))
        if not out:
            return np.zeros((0, 3, self.num_output_channels), np.float32)
        return np.concatenate(out)


# ---------------------------------------------------------------------------
# 2D -> 3D lifting
# ---------------------------------------------------------------------------
def lift_to_3d(
    points_2d, cropzone, camera_matrices, *, device: torch.device | str
) -> np.ndarray:
    """Triangulate per-camera decoded peaks to 3D, batched over frames.

    Args:
      points_2d: (F, 4, N, 2) crop-local [x, y] peaks per camera.
      cropzone: (F, 4, 2) [y, x] crop offsets.
      camera_matrices: (4, 3, 4) full-sensor DLT matrices.
      device: where the triangulation runs.

    Returns:
      (F, N, 3) float32 numpy: the mean over the 6 camera pairs.
    """
    def f32(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    with torch.inference_mode():
        full = geometry.uncrop_points(f32(points_2d), f32(cropzone))
        pts = geometry.triangulate_multiview(f32(camera_matrices), full)
    return pts.cpu().numpy()
