"""Share of the rows staged that are zero padding, in %: the port's
``FrameStager`` counters (``tracing.counts()``), ``stage.padded_rows`` over
``stage.rows + stage.padded_rows``, over the run (they are never reset; the
set-up's warm-up is among them)."""

from portbench import spans


def read(t):
    s = spans.of(t)
    c = s.counts if s is not None else None
    if not c or not c["stage.rows"] + c["stage.padded_rows"]:
        return None
    return 100.0 * c["stage.padded_rows"] / (c["stage.rows"] + c["stage.padded_rows"])
