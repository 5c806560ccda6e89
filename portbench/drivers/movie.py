"""Whole movies through ``Predictor.predict_movie``, back to back.

The movie is ``movie_frames`` distinct uniform float32 frames in pageable
host memory (a reader's hand-over), decoded whole at ``prefetch`` chunks in
flight, call after call, until the window closes. ``correct``: the frames
of ``check_chunks`` chunks drawn from the seed are run through the plain
reference once the window has closed, and every call's peaks of those
frames are read against it.
"""

from __future__ import annotations

import numpy as np
from torch.autograd.profiler import record_function

from ..serving import Served
from ..weights import SAMPLE, seed_stream, uniform_frames


class Driver:
    def __init__(self, ctx):
        t = ctx.traffic
        self.ctx = ctx
        self.served = Served(ctx)
        self.prefetch = t["prefetch"]
        self.movie = uniform_frames(t["movie_frames"], self.served.frame_shape, ctx.seed,
                                    ctx.device)
        # warm-up: the window's only shape is a whole chunk
        self.served.pred.predict_movie(self.movie[: t["warmup_frames"]], prefetch=self.prefetch)
        self.outputs: list[np.ndarray] = []

    def unit(self) -> int:
        with record_function("portbench.predict_movie"):
            out = self.served.pred.predict_movie(self.movie, prefetch=self.prefetch)
        self.outputs.append(out)
        return out.shape[0]

    def sync(self) -> None:
        """``predict_movie`` returns host arrays: nothing is left in flight."""

    def end_to_end(self, window_s: float, useful: int) -> dict:
        return {"serve_fps": useful / window_s}

    def work(self) -> dict:
        return self.served.work()

    def release(self) -> None:
        self.served.release()

    def _rows(self) -> np.ndarray:
        cs = self.served.chunk
        n_chunks = self.movie.shape[0] // cs
        rng = np.random.default_rng(seed_stream(self.ctx.seed, SAMPLE))
        pick = np.sort(rng.choice(n_chunks, self.ctx.traffic["check_chunks"], replace=False))
        return np.concatenate([np.arange(c * cs, (c + 1) * cs) for c in pick])

    def numbers(self) -> dict:
        rows = self._rows()
        return self.served.numbers(self.movie[rows], [o[rows] for o in self.outputs])

    def control_numbers(self) -> dict:
        return self.served.control_numbers(self.movie[self._rows()])
