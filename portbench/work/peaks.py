"""One NVIDIA H100 SXM5 (80 GB HBM3): NVIDIA's datasheet, dense rates
(half the "with sparsity" figures), at the full 700 W power limit."""

PEAK_FLOPS = {
    "bf16": 989e12,     # tensor cores
    "tf32": 495e12,     # tensor cores
    "f32": 67e12,       # CUDA cores, no tensor core
}
HBM_BW = 3.35e12        # bytes/s
