"""Share of its roofline of the port's custom op ``ftl_fusion``, in % (the
4-camera disentanglement model's middle: the 1x1s, both FTLs, the fusion
and its BatchNorms, the skip): the bound seconds of its calls in the traced
stretch (operations at the bf16 peak or bytes at the memory peak, the
larger, from the configuration's shapes) over the device seconds the
profiler attributes to the op."""

from portbench.trace import roofline_pct

OP = "pose_estimation::ftl_fusion"


def read(t):
    return roofline_pct(t, OP)
