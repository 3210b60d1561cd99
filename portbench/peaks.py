"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates, 700 W)."""

BF16_FLOPS = 989e12  # tensor cores, bfloat16
TF32_FLOPS = 494.7e12  # tensor cores, TF32: the most a float32 step could reach there
F32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES = 3.35e12  # bytes per second
