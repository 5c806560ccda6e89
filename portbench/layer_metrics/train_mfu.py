"""The whole training step's share of the card's dense bf16 peak, in %:
three times the forward's operations per sample, counted from the
configuration's shapes, times the samples trained in the traced stretch,
over its length."""

from portbench.work import PEAK_OPS


def read(t):
    if t.work.get("kind") != "train" or not t.useful or t.window_s <= 0:
        return None
    return 100.0 * t.work["flops_per_useful"] * t.useful / t.window_s / PEAK_OPS["bf16"]
