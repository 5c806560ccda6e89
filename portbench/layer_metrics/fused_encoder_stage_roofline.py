"""Share of its roofline of the port's custom op ``fused_encoder_stage``, in %
(kernel B1: one encoder stage, three dilated 3x3 convs and a pool): the bound seconds of its calls in the traced stretch
(operations at the bf16 peak or bytes at the memory peak, the larger, from
the configuration's shapes) over the device seconds the profiler
attributes to the op."""

from portbench.trace import roofline_pct

OP = "pose_estimation::fused_encoder_stage"


def read(t):
    return roofline_pct(t, OP)
