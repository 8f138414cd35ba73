"""Hand-written Hopper kernels of the port, each beside its plain version.

Ported so far: ``agg_reduce`` (segmented), its fused aggregate + quantize
form, and the compressed uplink's per-row quantize, dequantize and top-k
mask. The reference's other Pallas kernels (flash attention, RG-LRU and
RWKV6 scans) are listed in ROADMAP.md Queue 2.
"""
from repro_torch.kernels.agg_reduce import (
    agg_reduce,
    agg_reduce_quant,
    segment_agg_reduce,
    segment_agg_reduce_plain,
    segment_agg_reduce_quant,
    segment_agg_reduce_quant_plain,
)
from repro_torch.kernels.quantize import (
    dequantize_rows,
    dequantize_rows_plain,
    quantize_rows,
    quantize_rows_plain,
    topk_mask_rows,
    topk_mask_rows_plain,
)

__all__ = ["agg_reduce", "agg_reduce_quant", "segment_agg_reduce",
           "segment_agg_reduce_plain", "segment_agg_reduce_quant",
           "segment_agg_reduce_quant_plain", "dequantize_rows",
           "dequantize_rows_plain", "quantize_rows", "quantize_rows_plain",
           "topk_mask_rows", "topk_mask_rows_plain"]
