"""Share of its roofline of the port's custom op ``fused_decoder``, in %
(kernel B2: the four-layer decoder): the bound seconds of its calls in the traced stretch
(operations at the bf16 peak or bytes at the memory peak, the larger, from
the configuration's shapes) over the device seconds the profiler
attributes to the op."""

from portbench.trace import roofline_pct

OP = "pose_estimation::fused_decoder"


def read(t):
    return roofline_pct(t, OP)
