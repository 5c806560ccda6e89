"""Seeded weights and inputs, made on the device from ``--seed``.

Weights are flax-layout float32 arrays (the port's ``Predictor`` and the
plain references both take them): one normal draw for all of a model's
parameters on the device, scaled per leaf in one product, copied to the
host once. The port bridges the host arrays itself; the references read
the device copy.
"""

from __future__ import annotations

import numpy as np
import torch

# (std, offset) of each kind of leaf
KINDS = {
    "kernel": None,  # std 1 / sqrt(fan_in): the variance of flax's lecun_normal
    "bias": (0.05, 0.0),
    "scale": (0.1, 1.0),  # LayerNorm scales around 1
    "shift": (0.1, 0.0),  # LayerNorm biases
    "embed": (1.0, 0.0),  # a positional embedding: flax's normal(1.0)
}
# purposes a run draws for, each from a stream of its own
WEIGHTS, FRAMES, SAMPLE, ORDER, POOL = range(1, 6)


def seed_stream(seed: int, purpose: int) -> int:
    """A 64-bit seed for one purpose of one run."""
    ss = np.random.SeedSequence([int(seed) % 2**64, purpose])
    return int(ss.generate_state(1, np.uint64)[0])


def generator(seed: int, purpose: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_stream(seed, purpose))


def make_tree(
    leaves: list[tuple[str, tuple, str, int]], seed: int, device: torch.device
) -> tuple[dict, dict[str, torch.Tensor]]:
    """``leaves``: (``a/b/name`` path, shape, kind, fan_in). Returns the
    nested flax-layout tree of float32 numpy arrays and the same values as
    a flat dict of device tensors by path."""
    counts = [int(np.prod(shape)) for _, shape, _, _ in leaves]
    std = torch.tensor([fan ** -0.5 if kind == "kernel" else KINDS[kind][0]
                        for _, _, kind, fan in leaves], device=device)
    off = torch.tensor([0.0 if kind == "kernel" else KINDS[kind][1]
                        for _, _, kind, _ in leaves], device=device)
    n = torch.tensor(counts, device=device)
    flat = torch.randn(sum(counts), generator=generator(seed, WEIGHTS, device),
                       device=device)
    flat = flat * std.repeat_interleave(n) + off.repeat_interleave(n)
    host = flat.cpu().numpy()
    tree: dict = {}
    dev: dict[str, torch.Tensor] = {}
    start = 0
    for (path, shape, _, _), c in zip(leaves, counts):
        *scopes, name = path.split("/")
        node = tree
        for s in scopes:
            node = node.setdefault(s, {})
        node[name] = host[start : start + c].reshape(shape)
        dev[path] = flat[start : start + c].reshape(shape)
        start += c
    return tree, dev


def uniform_frames(
    n: int, shape: tuple, seed: int, device: torch.device, piece: int = 512,
) -> np.ndarray:
    """``n`` distinct uniform [0, 1) float32 frames of ``shape``, drawn on the
    device in pieces and copied once into pageable host memory, as a reader
    hands a movie over."""
    out = torch.empty((n, *shape), dtype=torch.float32)
    gen = generator(seed, FRAMES, device)
    for i in range(0, n, piece):
        m = min(piece, n - i)
        out[i : i + m].copy_(torch.rand((m, *shape), generator=gen, device=device))
    return out.numpy()
