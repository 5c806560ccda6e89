"""The whole served forward's share of the card's dense bf16 peak, in %:
the model's operations per useful (unpadded) frame, counted from the
configuration's shapes, times the frames served in the traced stretch,
over its length. Padded rows count no work."""

from portbench.work import PEAK_OPS


def read(t):
    if t.work.get("kind") != "serve" or not t.useful or t.window_s <= 0:
        return None
    return 100.0 * t.work["flops_per_useful"] * t.useful / t.window_s / PEAK_OPS["bf16"]
