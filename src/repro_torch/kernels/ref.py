"""Naive PyTorch oracles for the attention kernels (port of the reference
package's ``kernels/ref.py``: full score matrices, f32 math, output in the
query's dtype).  ``wkv6_ref`` and ``rglru_scan_ref`` arrive with their
kernels."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, scale: Optional[float] = None):
    """q: [B, H, S, hd]; k, v: [B, K, S, hd] -> [B, H, S, hd] (naive)."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kk = torch.repeat_interleave(k, G, dim=1)
    vv = torch.repeat_interleave(v, G, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= (qp - kp) < window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv.float()).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, k_positions, q_position, *,
                         window: int = 0, softcap: float = 0.0,
                         scale: Optional[float] = None):
    """q: [B, H, hd]; caches [B, K, S, hd]; -> [B, H, hd]."""
    B, H, hd = q.shape
    K = k_cache.shape[1]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, K, G, hd)
    logits = torch.einsum("bkgd,bksd->bkgs", qg.float(),
                          k_cache.float()) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    valid = (k_positions >= 0) & (k_positions <= q_position[:, None])
    if window > 0:
        valid &= (q_position[:, None] - k_positions) < window
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)
