"""Share of the traced stretch in which the card is idle while the host
stages a chunk, in %: the idle time put down to ``pe.stage``,
``pe.stage.wait`` and ``pe.stage.fill`` (the innermost of the port's spans
around it, ``infer.FrameStager``) over the stretch. Prints the whole
partition on standard error."""

import sys

from portbench import spans

STAGE = ("pe.stage", "pe.stage.wait", "pe.stage.fill")


def read(t):
    s = spans.of(t)
    if s is None or not s.count("pe.stage") or s.window_s <= 0:
        return None
    print(spans.describe(s), file=sys.stderr)
    return 100.0 * s.idle(*STAGE) / s.window_s
