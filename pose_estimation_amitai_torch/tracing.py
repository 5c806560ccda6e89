"""Spans and counters of the port's serving path and train step.

A span is a ``torch.autograd.profiler.record_function`` range that exists
only while some ``torch.profiler`` runs (the Trainer's ``profile`` key,
``profile_routes``, a benchmark's tracer): it then lies on that profiler's
clock beside the card's activities. With no profiler running, :func:`span`
is one flag check that returns a shared no-op context: no dispatcher call,
no allocation, no synchronise. Under ``torch.export`` or ``torch.compile``
tracing it is the no-op too, so no traced program holds a profiler node.

Spans nest by the host's call stack:

* ``pe.call``: one ``Predictor.__call__`` (a clip); its chunks' spans nest
  under it;
* ``pe.movie``: one ``Predictor.predict_movie``; the ragged tail's
  ``pe.call`` nests inside;
* ``pe.stage``: one chunk through ``infer.FrameStager`` (slot, fill, the
  host-to-device enqueue, the pad);
* ``pe.stage.wait``: the host blocked until a pinned ring buffer's last copy
  has run;
* ``pe.stage.fill``: the host copy of the chunk's frames (into the pinned
  buffer; on the CPU path, ``torch.as_tensor(...).to(...)``);
* ``pe.forward``: the host's enqueue of the route's forward;
* ``pe.ftl``: inside ``pe.forward``, the host's enqueue of the
  disentanglement model's ``ftl_fusion`` op (models/fast_infer.py);
* ``pe.decode``: the host's enqueue of the peak decode;
* ``pe.fetch``: the host blocked on a chunk's peaks;
* ``pe.train.step``: one ``train.loop`` train step;
* ``pe.train.batch``: a microbatch's gather, warp and targets;
* ``pe.train.grads``: a microbatch's forward and backward;
* ``pe.train.adam``: the Adam update.

Counters are attributes of the code that does the work, always on and never
reset; a reader takes differences of :func:`counts` (the stager's) or of
the kernels' own: ``fused_encoder_stage.launches`` (B1),
``fused_decoder.launches`` (B2), ``hopper_ftl.ftl_fusion_kernel.launches``
(the disentanglement model's middle on its bf16 kernel),
``hopper_ftl.packed_weights.launches`` (that kernel's weights packed, once
for each set) and ``ftl_fusion.launches`` (the middle on the "gemm" composition: float32, or
widths the kernel does not take).
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "pe."
SPANS = (
    "pe.call", "pe.movie", "pe.stage", "pe.stage.wait", "pe.stage.fill", "pe.forward",
    "pe.ftl", "pe.decode", "pe.fetch", "pe.train.step", "pe.train.batch", "pe.train.grads",
    "pe.train.adam",
)
_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` (one of :data:`SPANS`) while a
    profiler runs outside compile or export tracing; else a shared no-op."""
    if torch.autograd._profiler_enabled() and not torch.compiler.is_compiling():
        return torch.autograd.profiler.record_function(name)
    return _OFF


def counts() -> dict[str, int]:
    """The serving path's counters: the frames staged, and the zero rows that
    padded them to whole chunks."""
    from .infer import FrameStager

    return {"stage.rows": FrameStager.frames, "stage.padded_rows": FrameStager.padded_rows}
