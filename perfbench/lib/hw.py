"""NVIDIA H100 SXM peaks (data sheet: dense rates without sparsity, at the
full 700 W power limit).  A frozen copy for the benchmark: rooflines and
MFU are read against these numbers, whatever the program's own copy says.
"""
#: bf16 tensor-core peak, dense
PEAK_FLOPS_BF16 = 989e12
#: float32 outside the tensor cores
PEAK_FLOPS_F32 = 67e12
#: HBM3 bandwidth
HBM_BW = 3.35e12
#: HBM3 capacity
HBM_BYTES = 80e9

PEAKS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_F32}
