"""Hand-written Hopper kernels of the port, each beside its plain version.

Only ``agg_reduce`` is ported so far; the reference's other Pallas kernels
(quantize, top-k, fused aggregate+quantize, flash attention, RG-LRU and
RWKV6 scans) are listed in ROADMAP.md Queue 2.
"""
from repro_torch.kernels.agg_reduce import (
    agg_reduce,
    segment_agg_reduce,
    segment_agg_reduce_plain,
)

__all__ = ["agg_reduce", "segment_agg_reduce", "segment_agg_reduce_plain"]
