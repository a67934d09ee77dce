"""A dense decoder-only transformer of the Llama family (Yi, arXiv:2403.04652)
in plain float32 PyTorch, over whole sequences, with no cache.

Per layer: RMSNorm scaled by ``1 + scale`` (eps 1e-6), grouped-query
attention with half-split rotary embeddings on q and k (base
``rope_theta``) and a causal mask, a residual add; RMSNorm, a SwiGLU MLP
(``silu(x W_gate) * (x W_up) W_down``), a residual add.  A final RMSNorm
and the tied embedding table as the output head.  The weight tree is the
served model's: ``embed [V, D]``, ``final_norm/scale``, and
``blocks/0/...`` leaves stacked over the layers, matrices laid out
[in, out].

``quant="fp8"`` computes every product of two operands (projections, the
attention's QK^T and PV, the output head) on operands rounded to float8
e4m3 with a scale per row of the left operand and per column of the right
one: the lower precision that the correctness check's control reads.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from perfbench.reference.common import f32_matmuls, mm, rmsnorm


def _rope(x, positions, theta: float):
    """x [N, S, heads, hd]; half-split rotation (first half pairs with
    second half)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = positions.float()[:, None] * inv[None]          # [S, hd/2]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, quant: Optional[str]):
    """q [N, S, H, hd], k/v [N, S, K, hd]; causal, GQA."""
    N, S, H, hd = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # [N,H,S,hd]
    logits = mm(qh, kh.transpose(-1, -2), quant) / hd ** 0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return mm(p, vh, quant).permute(0, 2, 1, 3)


def logits_at(params: Dict, cfg: Dict, tokens: torch.Tensor,
              positions: Sequence[int], quant: Optional[str] = None
              ) -> torch.Tensor:
    """Next-token logits [N, len(positions), V] (f32) of the token
    sequences ``tokens`` [N, S] at ``positions``."""
    with f32_matmuls():
        return _logits_at(params, cfg, tokens, positions, quant)


def _logits_at(params, cfg, tokens, positions, quant):
    N, S = tokens.shape
    H, K, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    emb = params["embed"].float()
    x = emb[tokens.long()]
    pos = torch.arange(S, device=tokens.device)
    blk = params["blocks"]["0"]
    for j in range(cfg["num_layers"]):
        a, m = blk["attn"], blk["mlp"]
        h = rmsnorm(x, blk["ln1"]["scale"][j])
        q = mm(h, a["wq"][j], quant).reshape(N, S, H, hd)
        k = mm(h, a["wk"][j], quant).reshape(N, S, K, hd)
        v = mm(h, a["wv"][j], quant).reshape(N, S, K, hd)
        q, k = (_rope(t, pos, cfg["rope_theta"]) for t in (q, k))
        o = _attention(q, k, v, quant).reshape(N, S, H * hd)
        x = x + mm(o, a["wo"][j], quant)
        h = rmsnorm(x, blk["ln2"]["scale"][j])
        gate = torch.nn.functional.silu(mm(h, m["w_gate"][j], quant))
        x = x + mm(gate * mm(h, m["w_up"][j], quant), m["w_down"][j], quant)
    idx = torch.as_tensor(list(positions), device=tokens.device)
    x = rmsnorm(x[:, idx], params["final_norm"]["scale"])
    return mm(x, emb.T, quant)[..., :cfg["vocab_size"]]
