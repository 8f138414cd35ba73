"""The target card's constants: one NVIDIA H100 SXM5 (80 GB HBM3), the
counterpart of ``repro/launch/hw.py``'s TPU v5e-class model.

These parameterize the roofline terms of ``launch.roofline``:

    compute    = Σ_type flops[type] / PEAK_FLOPS[type]
    memory     = bytes / HBM_BW
    collective = Σ_axis axis_bytes / the axis's link rate

Sources: [DS] NVIDIA H100 Tensor Core GPU datasheet (SXM5 column, dense
rates, i.e. half the "with sparsity" figures); [WP] NVIDIA H100 Tensor Core
GPU Architecture whitepaper (Hopper); [DGX] NVIDIA DGX H100 user guide
(system topology). The names the reference also has keep its names.
"""

PEAK_FLOPS_BF16 = 989e12      # [DS] BF16 tensor core, dense (1,979 with sparsity)
PEAK_FLOPS_FP16 = 989e12      # [DS] FP16 tensor core, dense
PEAK_FLOPS_TF32 = 495e12      # [DS] TF32 tensor core, dense (989 with sparsity)
PEAK_FLOPS_FP32 = 67e12       # [DS] FP32 on the CUDA cores (no tensor core)
PEAK_FLOPS_FP64 = 67e12       # [DS] FP64 tensor core
PEAK_OPS_INT8 = 1979e12       # [DS] INT8 tensor core, dense (3,958 with sparsity)

# flops of each type the counter reckons, at that type's peak
PEAK_FLOPS = {"bf16": PEAK_FLOPS_BF16, "f16": PEAK_FLOPS_FP16, "tf32": PEAK_FLOPS_TF32,
              "f32": PEAK_FLOPS_FP32, "f64": PEAK_FLOPS_FP64, "int8": PEAK_OPS_INT8}

HBM_BW = 3.35e12              # [DS] HBM3 bandwidth, bytes/s
HBM_BYTES = 80 * 10 ** 9      # [DS] 80 GB of HBM3 (85.5e9 as the card reports it)

# NVLink 4 within a node of 8 cards: 18 links, 900 GB/s both directions
# together [DS, WP], so 450 GB/s each way; every intra-node mesh axis
# ("data", "model", "expert") rides it
NVLINK_BW = 450e9
# across nodes, one ConnectX-7 InfiniBand NDR port of 400 Gb/s per card
# [DGX]: 50 GB/s each way. The cross-pod "pod" hop rides it, the place of
# the reference's DCI_BW (the PON upstream of the mapping: the scarce link)
IB_BW = 400e9 / 8
