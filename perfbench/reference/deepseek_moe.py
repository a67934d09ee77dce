"""DeepSeekMoE 16B (arXiv:2401.06066; deepseek-ai/deepseek-moe-16b-base) in
plain float32 PyTorch, over whole sequences, with no cache.

Per layer l, on the residual x:

    h = x + MHA(RMSNorm(x))
    y = h + FFN_l(RMSNorm(h))
    FFN_l(u) = SwiGLU_dense(u)                       for l < first_k_dense
    FFN_l(u) = SwiGLU_shared(u) + sum_{e in top_k(s)} s_e SwiGLU_e(u),
               s = softmax(u W_router) over the experts, otherwise

with RMSNorm scaled by ``1 + scale`` (eps 1e-6), multi-head attention with
half-split rotary embeddings on q and k (base ``rope_theta``) and a causal
mask, ``SwiGLU(u) = (silu(u W_gate) * (u W_up)) W_down``, and the k routing
weights left as the softmax gives them where ``norm_topk_prob`` is false
(renormalised to sum to 1 where it is true).  A final RMSNorm and the
output head.  Each expert runs over the tokens routed to it only.

The weight tree is the served model's: ``embed [V, D]``, ``head [V, D]``
(the embedding where ``tie_embeddings`` holds), ``final_norm/
scale``; ``blocks/0/...`` the ``first_k_dense`` dense layers and
``blocks/1/...`` the MoE layers, each leaf stacked over its layers,
matrices laid out [in, out]; a MoE layer's ``moe/router [D, E]``, its
experts ``moe/w_gate|w_up [E, D, F]``, ``moe/w_down [E, F, D]`` and its
shared experts ``aux_mlp/...``.

Departures from the published model, each deliberate:

* the weights are whatever the caller passes (the tests and the benchmark
  draw them at random from a seed; no checkpoint is read);
* the 2 shared experts of width 1408 are one SwiGLU of width 2816: their
  gate and up columns and their down rows concatenated, the same function
  (the sum of the two experts' outputs);
* everything runs in float32 with TF32 off, where the published model
  runs in bfloat16;
* ties in the router go to the lower expert (a stable descending sort).

``quant="fp8"`` computes every product of two operands (projections, the
router, the experts, the attention's QK^T and PV, the output head) on
operands rounded to float8 e4m3 with a scale per row of the left operand
and per column of the right one: a lower precision than the served
bfloat16, the control a correctness check compares against.

The benchmark's own copy of the port's plain reference
(``src/repro_torch/reference/deepseek_moe.py``), the float32 pieces taken
from ``common.py``: nothing here imports the program, its kernels or its
plain versions, and later changes to the program cannot move it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

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
    """q [N, S, H, hd], k/v [N, S, K, hd]; causal."""
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


def _swiglu(u, w_gate, w_up, w_down, quant):
    g = torch.nn.functional.silu(mm(u, w_gate, quant))
    return mm(g * mm(u, w_up, quant), w_down, quant)


def route(u, router, k: int, norm_topk_prob: bool,
          quant: Optional[str] = None):
    """u [T, D] -> (weights [T, k], experts [T, k], probabilities [T, E]):
    the k largest softmax probabilities, ties to the lower expert."""
    probs = torch.softmax(mm(u, router, quant), dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    if norm_topk_prob:
        top_w = top_w / top_w.sum(-1, keepdim=True)
    return top_w, top_i, probs


def _moe(u, m, shared, cfg: Dict, quant, routes: Optional[List]):
    """u [T, D]: the shared experts plus each token's k routed experts,
    each expert over its own tokens."""
    top_w, top_i, probs = route(u, m["router"], cfg["num_experts_per_tok"],
                                cfg.get("norm_topk_prob", True), quant)
    if routes is not None:
        routes.append((top_i, probs, u))
    out = _swiglu(u, shared["w_gate"], shared["w_up"], shared["w_down"],
                  quant)
    for e in range(m["router"].shape[-1]):
        tok, slot = (top_i == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(u[tok], m["w_gate"][e], m["w_up"][e], m["w_down"][e],
                    quant)
        out.index_add_(0, tok, top_w[tok, slot, None] * y)
    return out


def _layers(params: Dict, cfg: Dict):
    """(block params, index) of each layer, in order."""
    n_dense = cfg.get("first_k_dense", 0)
    for layer in range(cfg["num_layers"]):
        if layer < n_dense:
            yield params["blocks"]["0"], layer
        else:
            yield params["blocks"]["1" if n_dense else "0"], layer - n_dense


def hidden(params: Dict, cfg: Dict, tokens: torch.Tensor,
           quant: Optional[str] = None, routes: Optional[List] = None):
    """The last layer's residual [N, S, D] (f32) of ``tokens`` [N, S];
    ``routes`` (a list) gets each MoE layer's (experts [N*S, k],
    probabilities [N*S, E], the router's input [N*S, D])."""
    N, S = tokens.shape
    H, K, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    x = params["embed"].float()[tokens.long()]
    pos = torch.arange(S, device=tokens.device)
    for blk, j in _layers(params, cfg):
        a = blk["attn"]
        h = rmsnorm(x, blk["ln1"]["scale"][j])
        q = mm(h, a["wq"][j], quant).reshape(N, S, H, hd)
        k = mm(h, a["wk"][j], quant).reshape(N, S, K, hd)
        v = mm(h, a["wv"][j], quant).reshape(N, S, K, hd)
        q, k = (_rope(t, pos, cfg["rope_theta"]) for t in (q, k))
        o = _attention(q, k, v, quant).reshape(N, S, H * hd)
        x = x + mm(o, a["wo"][j], quant)
        u = rmsnorm(x, blk["ln2"]["scale"][j]).reshape(N * S, -1)
        if "moe" in blk:
            m = {n: t[j] for n, t in blk["moe"].items()}
            shared = {n: t[j] for n, t in blk["aux_mlp"].items()}
            f = _moe(u, m, shared, cfg, quant, routes)
        else:
            d = blk["mlp"]
            f = _swiglu(u, d["w_gate"][j], d["w_up"][j], d["w_down"][j],
                        quant)
        x = x + f.reshape(N, S, -1)
    return x


def logits_at(params: Dict, cfg: Dict, tokens: torch.Tensor,
              positions: Sequence[int], quant: Optional[str] = None,
              routes: Optional[List] = None) -> torch.Tensor:
    """Next-token logits [N, len(positions), V] (f32) of the token
    sequences ``tokens`` [N, S] at ``positions``."""
    with f32_matmuls():
        x = hidden(params, cfg, tokens, quant, routes)
        idx = torch.as_tensor(list(positions), device=tokens.device)
        x = rmsnorm(x[:, idx], params["final_norm"]["scale"])
        head = params["embed" if cfg.get("tie_embeddings", True)
                      else "head"].float()
        return mm(x, head.T, quant)[..., :cfg["vocab_size"]]
