"""Kernels of the port: CUDA sources in ``csrc/``, wrappers, plain
versions, oracles and the placement registry (attention, the two
recurrences, and the decoder layer's fused elementwise glue)."""
from repro_torch.kernels import ops, ref  # noqa: F401
