"""Share of the traced stretch in which a host-to-device copy runs and no
other device work does (the staging that no kernel hides), in %."""


def read(t):
    if t.window_s <= 0:
        return None
    return 100.0 * (t.busy_s - t.compute_s) / t.window_s
