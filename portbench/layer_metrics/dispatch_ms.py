"""Host milliseconds a chunk spends enqueueing its forward and peak decode
(the port's ``pe.forward`` and ``pe.decode`` spans, in
``infer.Predictor._run_rows``): their host seconds in the traced stretch
over the count of ``pe.forward``."""

from portbench import spans


def read(t):
    s = spans.of(t)
    if s is None or not s.count("pe.forward"):
        return None
    return 1e3 * s.seconds("pe.forward", "pe.decode") / s.count("pe.forward")
