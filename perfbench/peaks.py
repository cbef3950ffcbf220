"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_TENSOR_OPS_PER_S = 495e12
BF16_TENSOR_OPS_PER_S = 989e12
