"""Share of the traced stretch with no device activity, in %."""


def read(t):
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
