"""Hand-written Hopper kernels of the port, each beside its plain version.

Every Pallas kernel of the reference has its counterpart: ``agg_reduce``
(segmented), its fused aggregate + quantize form, the compressed uplink's
per-row quantize, dequantize and top-k mask, and the language models'
flash attention, RG-LRU scan and chunked RWKV6 scan. The three LM kernels
also have hand-written backwards, which the TPU kernels lack (the reference
trains through jax.grad of its jnp forms). ``im2col``, the FEMNIST CNN's
patch gather, replaces no TPU kernel (the reference convolves with XLA).
"""
from repro_torch.kernels.agg_reduce import (
    agg_reduce,
    agg_reduce_quant,
    segment_agg_reduce,
    segment_agg_reduce_plain,
    segment_agg_reduce_quant,
    segment_agg_reduce_quant_plain,
)
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from repro_torch.kernels.im2col import im2col, im2col_plain
from repro_torch.kernels.quantize import (
    dequantize_rows,
    dequantize_rows_plain,
    quantize_rows,
    quantize_rows_plain,
    topk_mask_rows,
    topk_mask_rows_plain,
)
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd_plain, rglru_scan_plain
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_bwd_plain, rwkv6_scan_plain

__all__ = ["agg_reduce", "agg_reduce_quant", "segment_agg_reduce",
           "segment_agg_reduce_plain", "segment_agg_reduce_quant",
           "segment_agg_reduce_quant_plain", "dequantize_rows",
           "dequantize_rows_plain", "quantize_rows", "quantize_rows_plain",
           "topk_mask_rows", "topk_mask_rows_plain", "flash_attention",
           "flash_attention_bwd_plain", "flash_attention_plain", "im2col", "im2col_plain",
           "rglru_scan", "rglru_scan_bwd_plain", "rglru_scan_plain", "rwkv6_scan",
           "rwkv6_scan_bwd_plain", "rwkv6_scan_plain"]
