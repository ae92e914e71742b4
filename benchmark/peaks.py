"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W).

Every share of a peak or a roofline in this benchmark is stated against
these numbers; the card's power limit is printed beside each run.
"""

BF16_FLOPS = 989e12        # dense bf16 / fp16 tensor-core rate
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12         # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
MEMORY_BYTES = 80e9
