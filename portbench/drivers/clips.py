"""Short clips through ``Predictor.__call__``, one closed-loop caller.

Clip lengths are a fixed set of ``length_set`` values spread log-uniformly
over [``min_frames``, ``max_frames``] (the set's quantiles), gone through in
a new order drawn from the seed each round, so every seed offers the same
work; each clip is a slice, at an offset drawn from the seed, of a seeded
``buffer_frames``-frame host buffer. A clip's latency is the host clock
from the call to its returned peaks. ``correct``: ``check_clips`` clips
drawn from the seed among those the window finished, the longest always
among them, through the plain reference.
"""

from __future__ import annotations

import time

import numpy as np
from torch.autograd.profiler import record_function

from ..serving import Served
from ..weights import ORDER, SAMPLE, seed_stream, uniform_frames


def length_set(t: dict) -> np.ndarray:
    lo, hi, n = np.log(t["min_frames"]), np.log(t["max_frames"]), t["length_set"]
    return np.rint(np.exp(lo + (np.arange(n) + 0.5) / n * (hi - lo))).astype(int)


class Driver:
    def __init__(self, ctx):
        t = ctx.traffic
        self.ctx = ctx
        self.served = Served(ctx)
        self.buffer = uniform_frames(t["buffer_frames"], self.served.frame_shape, ctx.seed,
                                     ctx.device)
        self.lengths = length_set(t)
        self.rng = np.random.default_rng(seed_stream(ctx.seed, ORDER))
        self.queue: list[int] = []
        # warm-up: a whole chunk and a padded one, the window's only shapes
        self.served.pred(self.buffer[: self.served.chunk + self.served.chunk // 2])
        self.done: list[tuple[int, int, np.ndarray]] = []  # (offset, length, peaks)
        self.latency_s: list[float] = []

    def _next(self) -> tuple[int, int]:
        if not self.queue:
            self.queue = list(self.rng.permutation(self.lengths))
        n = int(self.queue.pop())
        off = int(self.rng.integers(0, self.buffer.shape[0] - n + 1))
        return off, n

    def unit(self) -> int:
        off, n = self._next()
        clip = self.buffer[off : off + n]
        t0 = time.perf_counter()
        with record_function("portbench.clip_call"):
            out = self.served.pred(clip)
        self.latency_s.append(time.perf_counter() - t0)
        self.done.append((off, n, out))
        return n

    def sync(self) -> None:
        """``__call__`` returns host arrays: nothing is left in flight."""

    def end_to_end(self, window_s: float, useful: int) -> dict:
        return {"serve_fps": useful / window_s,
                "clip_p95_ms": float(np.percentile(self.latency_s, 95)) * 1e3}

    def work(self) -> dict:
        return self.served.work()

    def release(self) -> None:
        self.served.release()

    def _picked(self) -> list[tuple[int, int, np.ndarray]]:
        k = self.ctx.traffic["check_clips"]
        longest = max(range(len(self.done)), key=lambda i: self.done[i][1])
        rest = [i for i in range(len(self.done)) if i != longest]
        rng = np.random.default_rng(seed_stream(self.ctx.seed, SAMPLE))
        pick = [longest, *rng.choice(rest, min(k - 1, len(rest)), replace=False)]
        return [self.done[i] for i in sorted(pick)]

    def numbers(self) -> dict:
        return self.served.numbers(
            np.concatenate([self.buffer[o : o + n] for o, n, _ in self._picked()]),
            [np.concatenate([out for _, _, out in self._picked()])])

    def control_numbers(self) -> dict:
        return self.served.control_numbers(
            np.concatenate([self.buffer[o : o + n] for o, n, _ in self._picked()]))
