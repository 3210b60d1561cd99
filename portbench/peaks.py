"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates, 700 W)."""

BF16_FLOPS = 989e12  # tensor cores, bfloat16
F32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES = 3.35e12  # bytes per second
