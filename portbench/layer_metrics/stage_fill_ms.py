"""Host milliseconds a chunk spends filling its frames into the staging
buffer (the port's ``pe.stage.fill`` span, in ``infer.FrameStager``): the
span's host seconds in the traced stretch over the count of ``pe.stage``."""

from portbench import spans


def read(t):
    s = spans.of(t)
    if s is None or not s.count("pe.stage") or not s.count("pe.stage.fill"):
        return None
    return 1e3 * s.seconds("pe.stage.fill") / s.count("pe.stage")
