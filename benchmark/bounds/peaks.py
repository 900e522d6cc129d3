"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the card's 700 W limit). A share of one of them is
reported with the card's power limit beside it."""

BF16_FLOPS = 989e12  # tensor cores, bfloat16 and float16
F32_FLOPS = 67e12  # CUDA cores, float32
BYTES_PER_S = 3.35e12  # HBM3
