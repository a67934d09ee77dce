"""Pieces the plain references share: float32 products with TF32 off, the
float8 rounding of the control, and the norms."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

#: float8 e4m3's largest finite value
_E4M3_MAX = 448.0


@contextlib.contextmanager
def f32_matmuls():
    """Full float32 products on the card: TF32 off for the duration."""
    b = torch.backends
    old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = False
    b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = old


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to e4m3's largest), back in f32."""
    x = x.float()
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def mm(a: torch.Tensor, b: torch.Tensor, quant: Optional[str] = None):
    """``a @ b`` in float32; with ``quant="fp8"`` on operands rounded to
    float8 (a per row, b per column of the product)."""
    if quant is None:
        return a.float() @ b.float()
    if quant != "fp8":
        raise ValueError(f"unknown quant {quant!r}")
    return fp8(a, -1) @ fp8(b, -2)


def rmsnorm(x, scale, eps: float = 1e-6):
    """RMSNorm scaled by ``1 + scale``."""
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (
        1.0 + scale.float())
