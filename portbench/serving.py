"""What the serving drivers share: the cell's ``Predictor`` on seeded
weights, and the plain reference's reading of what it served."""

from __future__ import annotations

import contextlib
import gc

import numpy as np
import torch

from . import compare, program
from .weights import make_tree

REF_BLOCK = 64  # frames a reference forward takes at once


@contextlib.contextmanager
def exact_float32():
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def argmax_peaks(maps: torch.Tensor) -> np.ndarray:
    """(n, H, W, K) maps -> (n, 3, K) [x, y, val] of each channel's maximum."""
    n, h, w, k = maps.shape
    flat = maps.reshape(n, h * w, k)
    val, idx = flat.max(dim=1)
    return torch.stack([(idx % w).float(), (idx // w).float(), val.float()], 1).cpu().numpy()


class Served:
    def __init__(self, ctx):
        self.ctx = ctx
        spec = ctx.spec
        self.tree, self.ref_params = make_tree(ctx.family.leaves(spec), ctx.seed, ctx.device)
        self.pred = program.predictor(spec, self.tree, ctx.device)
        self.chunk = spec["chunk_size"]
        self.frame_shape = tuple(spec["image_shape"])

    def work(self) -> dict:
        spec, fam = self.ctx.spec, self.ctx.family
        return {"kind": "serve", "flops_per_useful": fam.flops_per_frame(spec),
                "kernel_bounds": fam.kernel_bounds(spec, self.chunk)}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.pred = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, frames: np.ndarray, quant=lambda t: t) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(frames, np.float32)).to(self.ctx.device)
        with torch.no_grad(), exact_float32():
            return self.ctx.family.forward(self.ref_params, x, self.ctx.spec, quant)

    def numbers(self, frames: np.ndarray, served: list[np.ndarray]) -> dict:
        """The worst reading over every answer in ``served`` (each (n, 3, K)
        for the ``n`` frames of ``frames``)."""
        readings = []
        for i in range(0, frames.shape[0], REF_BLOCK):
            ref = self._reference(frames[i : i + REF_BLOCK])
            readings += [compare.peak_numbers(ref, s[i : i + REF_BLOCK],
                                              self.ctx.family.VAL_MODE) for s in served]
        return compare.worst(*readings)

    def control_numbers(self, frames: np.ndarray) -> dict:
        """The same numbers for the control: the reference computed in fp8
        put in the program's place, its argmax peaks read in the float32
        reference's maps."""
        readings = []
        for i in range(0, frames.shape[0], REF_BLOCK):
            ref = self._reference(frames[i : i + REF_BLOCK])
            ctl = argmax_peaks(self._reference(frames[i : i + REF_BLOCK], compare.fp8))
            readings.append(compare.peak_numbers(ref, ctl, self.ctx.family.VAL_MODE))
        return compare.worst(*readings)
