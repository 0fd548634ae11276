"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12          # dense bf16 / fp16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12    # HBM3
NVLINK_BYTES_PER_S = 450e9   # NVLink 4, each way (900 GB/s both ways)
