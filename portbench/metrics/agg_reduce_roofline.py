"""The segmented aggregate's share of its byte bound in the traced window:
the frozen bound of each call over the device time of the kernels
launched inside the wrapper's ``kernels.agg_reduce`` ranges."""
from portbench.harness.rooflines import segment_aggregate
from portbench.work.kernels import agg_reduce


def read(ctx):
    return segment_aggregate(ctx, "kernels.agg_reduce", agg_reduce)
