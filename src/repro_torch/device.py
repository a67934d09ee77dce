"""Device resolution shared by every entry point of the port.

The port runs on the CUDA device.  The CPU is used only when the caller
names it (the tests do); a missing card is an error, never a silent move
to the CPU."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA device.  Raises ``RuntimeError`` when CUDA
    is asked for (explicitly or by default) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
