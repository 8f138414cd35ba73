"""The fused aggregate + int8 quantize's share of its byte bound in the
traced window: the frozen bound of each θ call over the device time of
the kernels launched inside the wrapper's ``kernels.agg_reduce_quant``
ranges."""
from portbench.harness.rooflines import segment_aggregate
from portbench.work.kernels import agg_reduce_quant


def read(ctx):
    return segment_aggregate(ctx, "kernels.agg_reduce_quant", agg_reduce_quant)
