"""Published peaks of the card, the denominators of every share of a peak or
of a roofline the benchmark reports.

NVIDIA H100 SXM5 data sheet, dense rates (no sparsity), at the full power
limit of 700 W. A card set below it runs slower under load: the run prints
the card's ``power.limit`` on standard error beside the result, and a share
is always stated against these published peaks, never a measured one.
"""

from __future__ import annotations

# FLOP/s: float32 outside the tensor cores (the port's float32 path runs
# with TF32 off), and the dense bfloat16 tensor-core rate
FP32_FLOPS = 67e12
BF16_FLOPS = 989.4e12
# HBM3 bytes/s
HBM_BYTES = 3.35e12

CARD = "NVIDIA H100 SXM5 (data sheet, 700 W)"
