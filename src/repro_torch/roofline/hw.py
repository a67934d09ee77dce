"""NVIDIA H100 SXM constants for the roofline model (per GPU), from
NVIDIA's H100 data sheet (dense rates, without sparsity, at the full
700 W power limit; a card set below it runs slower under load).

The reference's constants describe its TPU.  Names that mean the same
quantity are kept; the interconnect and the host's group of chips are
named for what they are on this machine, each beside the reference name
it replaces.
"""
#: bf16 tensor-core peak, dense (data sheet: 989 TFLOP/s, SXM)
PEAK_FLOPS_BF16 = 989e12       # FLOP/s
#: float32 outside the tensor cores (data sheet: 67 TFLOP/s, SXM)
PEAK_FLOPS_F32 = 67e12         # FLOP/s
#: HBM3 bandwidth (data sheet: 3.35 TB/s, SXM)
HBM_BW = 3.35e12               # bytes/s
#: HBM3 capacity (data sheet: 80 GB)
HBM_BYTES = 80e9               # bytes
#: NVLink 4 (data sheet: 18 links, 900 GB/s total, both directions), so
#: 25 GB/s per link per direction; replaces ``ICI_BW_PER_LINK``
NVLINK_BW_PER_LINK = 25e9      # bytes/s per link, one direction
#: NVLink 4 links per GPU; replaces ``ICI_LINKS``
NVLINK_LINKS = 18
#: GPUs of one HGX H100 node, all to all over NVSwitch; replaces
#: ``CHIPS_PER_POD``
GPUS_PER_NODE = 8
