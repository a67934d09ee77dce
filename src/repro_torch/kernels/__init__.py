"""Attention kernels of the port: CUDA sources in ``csrc/``, wrappers,
plain versions, oracles and the placement registry."""
from repro_torch.kernels import ops, ref  # noqa: F401
