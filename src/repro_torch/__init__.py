"""PyTorch/CUDA port of the Cloudflow reproduction.

Mirrors the layout of the JAX package (``repro``), which stays the frozen
reference.  Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise instead of falling back."""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
