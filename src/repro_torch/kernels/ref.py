"""Naive PyTorch oracles for the kernels (port of the reference package's
``kernels/ref.py``): full score matrices for attention, f32 math, output
in the query's dtype; sequential f32 loops over time for the two
recurrences."""
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


def wkv6_state_ref(r, k, v, w, u, state=None):
    """Sequential WKV6 from ``state`` (zeros when None).  r,k,v,w:
    [B,T,H,hd]; u: [H,hd]; state: [B,H,hd,hd].  Returns (y [B,T,H,hd],
    final state [B,H,hd,hd]), both f32."""
    B, T, H, hd = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    S = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    ys = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # [B,H,i,j]
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], S + uf * kv))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1), S


def wkv6_ref(r, k, v, w, u):
    """Sequential WKV6.  r,k,v,w: [B,T,H,hd]; u: [H,hd] -> y [B,T,H,hd] f32."""
    return wkv6_state_ref(r, k, v, w, u)[0]


def rglru_scan_ref(a, x, h0=None):
    """Sequential diagonal recurrence.  a, x: [B,T,R] -> h traj [B,T,R] f32."""
    B, T, R = a.shape
    h = (torch.zeros((B, R), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    af, xf = a.float(), x.float()
    hs = []
    for t in range(T):
        h = af[:, t] * h + xf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
