"""Batched inference: frames -> heatmaps -> keypoints -> 3D (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/infer.py`` for every model
family: the CNN family (the flagship per-wing ``BasicNet``, coarse and C2F,
``TwoWingsNet``, ``MultiCamNet``), the ViT families (``ViTPoseNet``,
``ViT4Cameras``), the BatchNorm families (``ResNetHeatmapNet``,
``GPTResNet``: ``batch_stats``) and the disentangled camera-matrix model
(``FourCamDisentangled``: ``cameras``, one row per sample):

* ``Predictor`` — chunked forward (tail zero-padded, its camera rows the
  last sample's, padded rows dropped) and peak decode on the device. Routes
  (``serving_path``): ``"module"``, the ``nn.Module`` forward (the port's
  counterpart of JAX's ``"flax"`` route), for every family; ``"fused"``, the hand-written Hopper kernels:
  for the flagship ``BasicNet`` the encoder-stage and decoder kernels
  (models/fast_infer.py), for a ViT the same module with every attention
  core on the attention kernel (ops/hopper_attention.py);
  ``"int8_resident"`` and ``"int8_fused"``, the calibrated int8 forwards of
  the flagship (models/quantized.py), the second through the int8 stage
  kernel; ``"int8_generic"``, every other model with its linear and conv
  layers on int8 (models/quantized_generic.py);
* ``predict_movie`` — keeps up to ``prefetch`` chunks in flight;
* ``FrameStager`` — a chunk's frames onto the device: on a ``cuda`` device
  from pinned host buffers on a copy stream of its own, so the copy of one
  chunk overlaps the compute of the ones before it;
* ``lift_to_3d`` — decoded per-camera peaks + cropZone + DLT cameras ->
  multi-view triangulated 3D points;
* ``evaluate_l2`` — pixel-L2 statistics of decoded against true peaks.

Public arrays keep the JAX contracts: NHWC frames (N, H, W, C) in, numpy
(N, 3, K) [x, y, val] peaks (and (N, H, W, K) maps) out.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from . import weights
from .config import Config
from .models import build_model, needs_camera_matrices
from .models.cnn import BasicNet
from .models.fast_infer import basicnet_apply_fused, kernel_params
from .models.vit import ViT4Cameras, ViTPoseNet
from .models.quantized import (
    calibrate, make_quantized_fused_forward, make_quantized_resident_forward,
)
from .models.quantized_generic import (
    calibration_batches, conv_layers_only, quantize_predict_fn,
)
from .ops import geometry, peaks
from .parallel.mesh import DATA_AXIS, data_rows

DECODES = ("argmax", "soft", "refined")
RING = 2  # pinned host buffers a stager fills in turn


def fill_pinned(dst: torch.Tensor, src) -> None:
    """Copy ``src`` (a numpy array or a CPU tensor of ``dst``'s shape) into
    the pinned host tensor ``dst``: by ``copy_``, on torch's intra-op
    threads, where torch can wrap the array (a tensor, or a C-contiguous,
    writeable numpy array in native byte order), else by numpy's one-thread
    assignment (read-only memmaps, strided or foreign-order arrays)."""
    if torch.is_tensor(src):
        dst.copy_(src)
    elif src.flags.c_contiguous and src.flags.writeable and src.dtype.isnative:
        dst.copy_(torch.from_numpy(src))
    else:
        dst.numpy()[...] = src


class FrameStager:
    """Chunks of frames onto one device, each zero-padded to ``rows`` rows
    (JAX pads with zeros): the port's counterpart of JAX's ``jnp.asarray``
    / ``jax.device_put``, whose runtime copies on a transfer stream of its
    own. The frames keep their dtype, as ``jnp.asarray`` keeps it.

    On a ``cuda`` device, a chunk on the host (numpy, or a CPU tensor) is
    filled into the next of a ring of ``RING`` pinned host buffers, made at
    first use for its dtype and frame shape and reused; the host waits, before
    refilling a buffer, for the event recorded after the last copy out of it.
    The buffer is copied with ``non_blocking=True`` on the stager's copy
    stream into a device tensor allocated on that stream, the padded rows
    zeroed there, and a "copied" event recorded, which the compute stream
    (the current stream at staging) waits on. The device tensor outlives its
    use by ``record_stream`` on the compute stream: the caching allocator
    hands its memory out again only after the work queued there on it has
    run. Nothing falls back to a pageable copy: a failed pin or stream
    raises.

    On the CPU: ``torch.as_tensor`` and the zero pad. A tensor already on a
    ``cuda`` device is used as it is (padded there)."""

    def __init__(self, device: torch.device, rows: int):
        self.device = torch.device(device)
        self.rows = rows
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)
        self._key = None  # (dtype, frame shape) of the ring
        self._buffers: list[torch.Tensor] = []
        self._copied: list = []  # the event after the last copy out of each buffer
        self._next = 0

    def buffers(self, dtype: torch.dtype, frame_shape: tuple) -> list[torch.Tensor]:
        """The pinned ring for frames of ``dtype`` and ``frame_shape``, made
        here at first use (after the copies out of an earlier ring)."""
        key = (dtype, tuple(frame_shape))
        if key != self._key:
            for ev in self._copied:
                if ev is not None:
                    ev.synchronize()
            self._buffers = []
            for _ in range(RING):
                buf = torch.empty((self.rows, *frame_shape), dtype=dtype, pin_memory=True)
                if not buf.is_pinned():
                    raise RuntimeError("the staging buffer was not pinned")
                self._buffers.append(buf)
            self._copied = [None] * RING
            self._next = 0
            self._key = key
        return self._buffers

    def __call__(self, chunk) -> torch.Tensor:
        """``chunk`` (at most ``rows`` frames, numpy or tensor) on the
        device, its rows then zeros up to ``rows``."""
        on_card = torch.is_tensor(chunk) and chunk.device.type == "cuda"
        if self.stream is None or on_card:
            t = torch.as_tensor(chunk).to(self.device, non_blocking=True)
            pad = self.rows - t.shape[0]
            return torch.cat([t, t.new_zeros((pad, *t.shape[1:]))]) if pad else t
        if not torch.is_tensor(chunk):
            chunk = np.asarray(chunk)
        dtype = chunk.dtype if torch.is_tensor(chunk) else _torch_dtype(chunk.dtype)
        n = chunk.shape[0]
        ring = self.buffers(dtype, chunk.shape[1:])
        i = self._next
        buf = ring[i]
        self._next = (i + 1) % RING
        if self._copied[i] is not None:
            self._copied[i].synchronize()  # the last copy out of it has run
        fill_pinned(buf[:n], chunk)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            out = torch.empty(buf.shape, dtype=dtype, device=self.device)
            out[:n].copy_(buf[:n], non_blocking=True)
            out[n:].zero_()
            copied = torch.cuda.Event()
            copied.record(self.stream)
        self._copied[i] = copied
        compute.wait_event(copied)
        out.record_stream(compute)
        return out


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


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
        calibration_frames=None,
        decode: str = "argmax",
        mesh=None,
        batch_stats=None,
        cameras=None,
        quantized_layers: str | None = None,
        fast_softmax: bool | None = None,
        model=None,
    ):
        """``params``: a flax-layout params tree (nested dicts of arrays),
        bridged by :mod:`..weights`. ``device``: where the model runs; there
        is no default. ``use_fused``: serve through the hand-written kernels
        (``serving_path == "fused"``): the torch-flavour ``BasicNet`` with
        3x3 kernels at dilation 2 through the stage and decoder kernels
        (``model`` stays None), a ViT with every attention core on the
        attention kernel; otherwise, for other ``BasicNet`` geometries and
        for the other CNN models (as JAX, which fuses the flagship only),
        the ``nn.Module`` forward (``"module"``).
        ``use_quantized``: calibrated int8 serving, scales from float32
        forwards of ``calibration_frames`` (required). The flagship
        geometry serves on ``"int8_resident"`` (int8 stored between
        layers, bf16 maps rounded out), or with ``use_fused`` too
        ``"int8_fused"`` (encoder stages through the int8 stage kernel);
        every other model on ``"int8_generic"`` (``use_fused`` ignored, as
        JAX ignores it), which calibrates on the first 32 frames in chunks
        of 8 (a camera model with its first camera rows) and serves bf16
        maps. ``quantized_layers``: ``None`` or 'all' quantises every
        linear and conv layer there, 'conv_only' the convs outside the
        ViT's patch embedding (the trunk stays bf16); anything else raises
        ``ValueError``. ``decode``: 'argmax'
        (tf_find_peaks parity), 'soft' (soft-argmax, vals from the map max)
        or 'refined' (sub-pixel log-parabola).

        ViT families only. A 4-camera ViT folds its views into the batch
        below ``chunk_size`` 128 and runs them one by one from there on.
        Argmax peaks-only serving skips the decoder's min-max normalisation
        (monotone, so the argmax is unchanged) and recovers the val channel
        from the per-sample (per-view for four cameras) min and max of the
        raw maps, the same float32 expression. ``fast_softmax``: ``None``
        engages the bf16 softmax chain (models/vit.py) for argmax
        peaks-only serving on the module route, ``False`` forces the exact
        float32 softmax, ``True`` forces the bf16 chain. The attention
        kernel computes the exact softmax, so the ``fused`` route keeps the
        chain off, and ``use_fused`` with ``fast_softmax=True`` raises
        ``ValueError``.

        ``model``: ``None`` builds the module from the config
        (``build_model(cfg, image_shape, num_output_channels)``); otherwise a
        function ``model(**serving_switches) -> nn.Module`` that builds it
        (an imported reference checkpoint's architecture,
        ``ImportedModel.module``), with the ViT serving switches where the
        predictor sets them.

        ``mesh``: a ``DeviceMesh`` (parallel/mesh.py ``make_mesh``), one
        process per device: each process serves its rows of every chunk
        over ``data`` on this predictor's route, and the peaks (and maps)
        are all-gathered, so every process returns the whole answer, as JAX
        returns the global array; ``chunk_size`` must divide over the
        mesh's processes.

        ``batch_stats``: the flax ``batch_stats`` tree of the BatchNorm
        families (their running averages). ``cameras``: ``(P, P_inv)``,
        (N, 4, 3, 4) and (N, 4, 4, 3), one row per sample of the frames the
        predictor will be called on, which the disentangled model needs
        (its call raises ``ValueError`` without them). These families serve
        on the ``"module"`` route; ``use_fused`` is ignored for them, as
        JAX ignores it."""
        if decode not in DECODES:
            raise ValueError(f"decode={decode!r}; expected one of {DECODES}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size={chunk_size} must be >= 1")
        if mesh is not None and chunk_size % mesh.size():
            raise ValueError(f"chunk_size={chunk_size} must divide over the mesh's "
                             f"{mesh.size()} processes")
        self.mesh = mesh
        self.cfg = cfg
        self.device = torch.device(device)
        self.image_shape = tuple(image_shape)
        self.chunk_size = chunk_size
        rows = self._rows()
        self._stager = FrameStager(self.device, rows.stop - rows.start)
        self.return_heatmaps = return_heatmaps
        self.decode = decode
        self.num_output_channels = num_output_channels
        self._needs_cams = needs_camera_matrices(cfg.model_type)
        self.cameras = None if cameras is None else tuple(
            np.asarray(c, np.float32) for c in cameras)
        if model is None:
            def model(**serving) -> nn.Module:
                return build_model(cfg, image_shape, num_output_channels, **serving)
        build = model
        with torch.device("meta"):  # the geometry only; no weights yet
            model = build()
        # the fused kernels and the int8 forwards serve the flagship
        # geometry (kernel 3, dilation 2), as JAX's do; other BasicNet
        # configs use the module
        is_basic = (
            type(model) is BasicNet and model.flavor == "torch"
            and model.kernel_size == 3 and model.dilation == 2
        )
        is_vit = isinstance(model, (ViTPoseNet, ViT4Cameras))
        fused_ok = use_fused and (is_basic or is_vit)
        # ViT argmax peaks-only serving: views whose raw maps' min and max
        # rescale the decoded vals (0: the maps come out as the model's)
        self._val_renorm_views = 0
        if is_vit:
            model = self._vit_for_serving(model, build, use_fused, fast_softmax)
        if use_quantized:
            if calibration_frames is None:
                raise ValueError("use_quantized needs calibration_frames")
            if is_basic:
                self.serving_path = "int8_fused" if use_fused else "int8_resident"
            else:
                layer_filter = _layer_filter(quantized_layers)
                self.serving_path = "int8_generic"
        else:
            self.serving_path = "fused" if fused_ok else "module"
        # the nn.Module of the module route and of a ViT's fused route
        self.model: nn.Module | None = None
        self._kparams = None
        self._quantized = None  # the int8 routes' forward

        def state_dict() -> dict[str, torch.Tensor]:
            return (weights.vit_state_dict(params) if is_vit else
                    weights.flax_to_state_dict(params, model, batch_stats or {}))

        if self.serving_path == "int8_generic":
            if self._needs_cams and self.cameras is None:
                raise ValueError("int8 serving of a camera model needs cameras")
            state = {k: v.to(self.device, torch.float32) for k, v in state_dict().items()}
            float_model = model.to_empty(device=self.device).eval()
            float_model.load_state_dict(state)
            calib = calibration_batches(
                calibration_frames, self.cameras if self._needs_cams else None,
                device=self.device)
            # bf16 maps out, as JAX serves this route
            self._quantized = quantize_predict_fn(
                float_model, state, calib, out_dtype=torch.bfloat16,
                layer_filter=layer_filter)
        elif use_quantized:
            scales = calibrate(params, np.asarray(calibration_frames),
                               device=self.device)
            if use_fused:
                self._quantized = make_quantized_fused_forward(
                    params, scales, device=self.device)
            else:
                # bf16 maps out, as JAX serves this route
                self._quantized = make_quantized_resident_forward(
                    params, scales, device=self.device,
                    out_dtype=torch.bfloat16)
        elif fused_ok and is_basic:
            self._kparams = kernel_params(params, model.dtype, self.device)
        else:
            self.model = model.to_empty(device=self.device).eval()
            self.model.load_state_dict(state_dict())
            if self.device.type == "cuda" and not is_vit:
                # NHWC frames permute to channels-last NCHW views; keep the
                # weights in the same format so cuDNN needs no transposes
                self.model.to(memory_format=torch.channels_last)

    def _vit_for_serving(
        self, model: nn.Module, build, use_fused: bool,
        fast_softmax: bool | None,
    ) -> nn.Module:
        """The ViT module as this predictor serves it (on the meta device):
        ``model`` rebuilt by ``build`` with its serving switches set, where
        flax would ``clone``; sets ``_val_renorm_views``."""
        peaks_only = self.decode == "argmax" and not self.return_heatmaps
        switches: dict = {}
        four = isinstance(model, ViT4Cameras)
        if four and self.chunk_size >= 128:
            # folded, the decoder's activations are 4x the chunk's
            switches["fold_views"] = False
        if peaks_only and (four or model.flavor == "torch"):
            self._val_renorm_views = 4 if four else 1
            switches["normalize_output"] = False
        if use_fused:
            if fast_softmax:
                raise ValueError(
                    "use_fused serves a ViT's exact float32 softmax through "
                    "the attention kernel; fast_softmax=True excludes it")
            switches["fused_attention"] = True
        elif fast_softmax if fast_softmax is not None else peaks_only:
            switches["fast_softmax"] = True
        with torch.device("meta"):
            return build(**switches)

    @classmethod
    def from_checkpoint(
        cls,
        cfg: Config | str,
        checkpoint_path: str,
        image_shape: tuple[int, int, int] = (192, 192, 4),
        num_output_channels: int = 18,
        *,
        import_reference: bool = False,
        dim_head: int | None = None,
        **kw,
    ) -> "Predictor":
        """Build from a checkpoint: a run directory (the port's
        ``best_model.pt``, else its ``checkpoint.pt``, else the JAX
        package's ``best_model.msgpack`` or ``checkpoint.msgpack``), a
        ``.pt`` file the port's trainer wrote (any ``save_params``
        snapshot), or a flax msgpack file (``weights.load_checkpoint``; no
        jax, and no msgpack for the ``.pt`` files) -- or a REFERENCE
        checkpoint (keras ``.h5``, torch ``checkpoint.pth``, TorchScript
        ``best_model.pth``), detected by its content or forced with
        ``import_reference=True`` and converted by :mod:`.importers`, or a
        ``cli import`` snapshot of one (the port's or the JAX package's).
        An imported model's architecture comes from the checkpoint itself
        (its weight shapes, or the snapshot's metadata), never from
        ``cfg``; it is built in ``cfg.compute_dtype`` and its output channel
        count replaces ``num_output_channels``. ``dim_head``: the head split
        of a torch ViT checkpoint (importers.py). ``device`` is required as
        for the constructor; the other keywords go to it."""
        from .importers import (
            import_reference_checkpoint,
            is_reference_checkpoint,
            load_imported_snapshot,
        )

        if isinstance(cfg, str):
            cfg = Config.from_json(cfg)
        if import_reference or is_reference_checkpoint(checkpoint_path):
            imported = import_reference_checkpoint(checkpoint_path, dim_head=dim_head)
        else:
            # a `cli import` snapshot carries the exact architecture and BN
            # statistics: rebuild from those, never from the config
            imported = load_imported_snapshot(checkpoint_path)
        if imported is not None:
            in_ch = imported.arch_kwargs.get("in_channels")
            if in_ch is not None and in_ch != image_shape[-1]:
                raise ValueError(
                    f"imported checkpoint expects {in_ch}-channel inputs, "
                    f"dataset provides {image_shape[-1]}")
            dtype = torch.float32 if cfg.compute_dtype == "float32" else torch.bfloat16
            with torch.device("meta"):
                imported.module(dtype)  # an encoder-only import raises ValueError here
            if imported.batch_stats:
                kw.setdefault("batch_stats", imported.batch_stats)

            def model(**serving) -> nn.Module:
                return imported.module(dtype, **serving)

            return cls(cfg, imported.params, image_shape,
                       imported.arch_kwargs["out_channels"], model=model, **kw)
        with torch.device("meta"):  # which layers are transposed convs
            model = (kw["model"]() if kw.get("model") is not None
                     else build_model(cfg, image_shape, num_output_channels))
        params, batch_stats = weights.load_checkpoint(checkpoint_path, model)
        kw.setdefault("batch_stats", batch_stats)
        return cls(cfg, params, image_shape, num_output_channels, **kw)

    # ------------------------------------------------------------------
    def forward(self, frames: torch.Tensor, *cameras: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) frames on the device (and a camera model's (B, 4, 3,
        4) P and (B, 4, 4, 3) P_inv) -> (B, H, W, K) maps over this
        predictor's serving route: float32, except a ViT's raw maps in
        argmax peaks-only serving, which stay in the compute dtype."""
        with torch.inference_mode():
            if self._quantized is not None:
                return self._quantized(frames, *cameras).float()
            if self._kparams is not None:
                return basicnet_apply_fused(self._kparams, frames)
            return self.model(frames, *cameras)

    def _run(self, frames: torch.Tensor, *cameras: torch.Tensor):
        """Maps and peaks of one padded chunk as :meth:`_stage` gives it;
        with a mesh, of this process's rows of it over ``data``, gathered so
        every process holds them all."""
        if self.mesh is None:
            return self._run_rows(frames, *cameras)
        res = self._run_rows(frames, *cameras)
        group = self.mesh.get_group(DATA_AXIS)
        if self.return_heatmaps:
            return tuple(_gather_rows(t, group) for t in res)
        return _gather_rows(res, group)

    def _run_rows(self, frames: torch.Tensor, *cameras: torch.Tensor):
        maps = self.forward(frames, *cameras)
        with torch.inference_mode():
            if self.decode == "soft":
                xy = peaks.find_peaks_soft_argmax(maps)  # (B, K, 2)
                vals = maps.amax(dim=(1, 2))
                pts = torch.cat([xy.transpose(1, 2), vals[:, None, :]], dim=1)
            elif self.decode == "refined":
                pts = peaks.find_peaks_refined(maps)
            else:
                pts = peaks.find_peaks_with_vals(maps)
                if self._val_renorm_views:
                    pts = _renorm_vals(pts, maps, self._val_renorm_views)
        if self.return_heatmaps:
            return maps, pts
        return pts

    def _rows(self) -> slice:
        """This process's rows of a chunk: all of them without a mesh."""
        if self.mesh is None:
            return slice(0, self.chunk_size)
        return data_rows(self.mesh, self.chunk_size)

    def _stage(self, frames, start: int) -> torch.Tensor:
        """This process's rows of the chunk of ``frames`` from ``start`` on
        the device, zero-padded to their full count (JAX pads with zeros);
        with a mesh only those rows are copied, as JAX's batch-sharded
        ``device_put`` places each device's own."""
        return self._stager(frames[start : start + self.chunk_size][self._rows()])

    def _stage_cameras(self, start: int, stop: int) -> tuple[torch.Tensor, ...]:
        """This process's camera rows of samples [start, stop) on the device
        (issued on the compute stream after their chunk's frames), padded to
        chunk_size with the last row (a zero camera would feed the FTL
        nothing sensible; the padded rows' outputs are dropped)."""
        if not self._needs_cams:
            return ()
        out = []
        for c in self.cameras:
            t = torch.from_numpy(c[start:stop]).to(self.device, non_blocking=True)
            pad = self.chunk_size - t.shape[0]
            t = torch.cat([t, t[-1:].expand(pad, *t.shape[1:])]) if pad else t
            out.append(t[self._rows()])
        return tuple(out)

    def __call__(self, frames):
        """Decode keypoints for (N, H, W, C) frames (numpy or tensor); N
        arbitrary.

        Returns (N, 3, K) [x, y, val] float32 numpy (plus (N, H, W, K) maps
        first if ``return_heatmaps``).
        """
        n = frames.shape[0]
        cs = self.chunk_size
        if self._needs_cams and self.cameras is None:
            raise ValueError(
                f"{self.cfg.model_type} takes camera matrices: construct the "
                "Predictor with cameras=(P, P_inv), one row per sample")
        outs, maps = [], []
        for i in range(0, n, cs):
            keep = min(cs, n - i)
            res = self._run(self._stage(frames, i), *self._stage_cameras(i, i + keep))
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

    def _fetch(self, res: torch.Tensor):
        """Start copying one chunk's peaks to the host: on a ``cuda`` device
        into pinned memory right behind the chunk's kernels on the compute
        stream, with an event, so that :func:`_fetched` waits for this chunk
        alone. A plain ``.cpu()`` would queue behind every chunk dispatched
        since, and drain the pipeline at each fetch."""
        if self.device.type != "cuda":
            return res, None
        host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
        host.copy_(res, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def predict_movie(self, frames, prefetch: int = 4) -> np.ndarray:
        """Throughput-oriented decode of a whole movie.

        Keeps at most ``prefetch`` chunks in flight: chunk i + prefetch is
        staged (on a ``cuda`` device, copied from pinned memory on the
        stager's own stream) and dispatched while the host waits for chunk
        i's small peak output (copied to pinned memory as its kernels end),
        so copies, compute and host work overlap, and device memory stays
        bounded at about ``prefetch`` chunks whatever the movie's length.
        The ragged tail goes through ``__call__``, as does a camera model's
        whole movie.
        """
        if self.return_heatmaps:
            raise ValueError("predict_movie decodes peaks only")
        if self._needs_cams:
            # the camera models take their per-sample rows chunk by chunk
            return self(frames)
        n = frames.shape[0]
        cs = self.chunk_size
        n_full = n // cs
        out: list[np.ndarray] = []
        in_flight: list[tuple] = []  # (host peaks, their copy's event)
        for i in range(n_full):
            in_flight.append(self._fetch(self._run(self._stage(frames, i * cs))))
            if len(in_flight) >= prefetch:
                out.append(_fetched(in_flight.pop(0)))
        out.extend(_fetched(r) for r in in_flight)
        if n_full * cs < n:
            out.append(self(frames[n_full * cs :]))
        if not out:
            return np.zeros((0, 3, self.num_output_channels), np.float32)
        return np.concatenate(out)


def _fetched(pending) -> np.ndarray:
    """The host array of a :meth:`Predictor._fetch`, once its copy has run."""
    host, done = pending
    if done is not None:
        done.synchronize()
    return host.numpy()


def _gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every process's rows of ``t``, in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _layer_filter(quantized_layers: str | None):
    """The ``int8_generic`` layer filter of ``quantized_layers``."""
    if quantized_layers in (None, "", "all"):
        return None
    if quantized_layers == "conv_only":
        return conv_layers_only
    raise ValueError(f"unknown quantized_layers={quantized_layers!r}; "
                     "expected 'all' or 'conv_only'")


def _renorm_vals(pts: torch.Tensor, maps: torch.Tensor, views: int) -> torch.Tensor:
    """Peaks decoded from raw ViT maps with the val channel of the
    normalised model: ``(val - lo) / (hi - lo + 1e-12)`` with the float32
    min and max of each sample's (each view's) raw maps, the expression the
    decoder's min-max normalisation evaluates on the same values."""
    b, h, w, c = maps.shape
    m32 = maps.float().reshape(b, h, w, views, c // views)
    lo = m32.amin(dim=(1, 2, 4))  # (B, V)
    hi = m32.amax(dim=(1, 2, 4))
    lo_c = lo.repeat_interleave(c // views, dim=1)  # (B, C)
    rng_c = (hi - lo).repeat_interleave(c // views, dim=1)
    vals = (pts[:, 2, :] - lo_c) / (rng_c + 1e-12)
    return torch.cat([pts[:, :2, :], vals[:, None, :]], dim=1)


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


def evaluate_l2(predictor: Predictor, frames, confmaps) -> dict:
    """Pixel-L2 statistics of the predicted against the ground-truth peaks
    (the argmax of each map stack; pytorch/train_pytorch.py:199-213): mean,
    std, max and the per-point means, over (N, K) distances."""
    pred_pts = predictor(frames)[:, :2, :]  # (N, 2, K)
    with torch.inference_mode():
        true_pts = peaks.find_peaks_with_vals(
            torch.as_tensor(np.asarray(confmaps, np.float32)))[:, :2, :].numpy()
    d = np.linalg.norm(pred_pts - true_pts, axis=1)  # (N, K)
    return {
        "l2_mean": float(d.mean()),
        "l2_std": float(d.std()),
        "l2_max": float(d.max()),
        "l2_per_point": d.mean(axis=0).tolist(),
    }
