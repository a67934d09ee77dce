"""Mixture-of-Experts FFN (port of the reference package's
``models/moe.py``, its single-device half).

Two functions compute the same thing:

* :func:`moe_apply_reference` — the reference's exact masked combine: every
  expert runs over every token and a token keeps the outputs of the k
  experts it was routed to.  Its work grows with T x E; it is the plain
  version, which the tests and ``chip_smoke.py`` hold the served path to.
* :func:`moe_apply` — the served path.  The T*k routed (token, expert)
  pairs are sorted by expert, so each expert's rows are contiguous, and
  one grouped product per weight matrix (``torch._grouped_mm``, with the
  group ends on the device) runs each expert over its own rows only; the
  gated rows are then added into an f32 output.  Its work grows with the
  routed pairs, no token is dropped (the reference at world size 1 drops
  none either: ``capacity_factor`` plays no part), and nothing is read
  back to the host, so the static verifier can walk it.

The expert-parallel path of the reference (``_capacity``,
``_dispatch_combine_local``, ``moe_apply_ep``) runs only under a mesh
with more than one model shard, and waits for the port of ``launch/`` and
``models/partition.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

_EXPERT_MATS = ("w_gate", "w_up", "w_down")


def moe_init(cfg: ModelConfig, dtype: torch.dtype, n_layers: int, *,
             generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Stacked MoE params for ``n_layers`` MoE layers: an f32 router
    ``[n, D, E]`` and expert stacks ``[n, E, D, F]`` / ``[n, E, F, D]``,
    normal(0, 1/sqrt(fan_in)) as in the reference.  Each expert's slice is
    drawn in f32 and written straight into the ``dtype`` stack, so no f32
    copy of a whole stack (35.7 GB for arctic's two-layer ``w_up``) is
    ever held."""
    D, F, E = cfg.d_model, cfg.expert_ff, cfg.num_experts

    def stack(shape, fan_in):
        out = torch.empty((n_layers, E) + shape, dtype=dtype, device=device)
        for i in range(n_layers):
            for e in range(E):
                out[i, e] = layers.dense_init(shape, dtype, fan_in=fan_in,
                                              generator=generator,
                                              device=device)
        return out

    p = {"router": layers.dense_init((n_layers, D, E), torch.float32,
                                     fan_in=D, generator=generator,
                                     device=device),
         "w_up": stack((D, F), D),
         "w_down": stack((F, D), F)}
    if cfg.gated_mlp:
        p["w_gate"] = stack((D, F), D)
    return p


def quantize_expert_weights(moe_params: Dict[str, Any]) -> Dict[str, Any]:
    """int8-quantize the stacked expert weights: each ``[n, E, D, F]``-like
    tensor becomes ``{"q": int8, "s": f32 [n, E, F]}``, one scale per
    (expert, out-feature) over the reduction dim, ``max|w| / 127`` (at
    least 1e-8 / 127), values rounded half to even and clipped to +-127.
    Computed one (layer, expert) slice at a time, in f32."""
    out = dict(moe_params)
    for name in _EXPERT_MATS:
        if name not in moe_params:
            continue
        w = moe_params[name]
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty(w.shape[:2] + w.shape[-1:], dtype=torch.float32,
                        device=w.device)
        for i in range(w.shape[0]):
            for e in range(w.shape[1]):
                wf = w[i, e].float()
                amax = torch.clamp_min(wf.abs().amax(dim=-2), 1e-8)
                # a tensor divisor, as in ``layers.kv_quantize``
                s[i, e] = amax / amax.new_tensor(127.0)
                q[i, e] = torch.clamp(torch.round(wf / s[i, e]), -127,
                                      127).to(torch.int8)
        out[name] = {"q": q, "s": s}
    return out


def _maybe_dequant(w, dtype=torch.bfloat16):
    """int8 weights back to ``dtype`` (bfloat16 by default, even in an f32
    model, as in the reference; its products then promote).  The product
    is taken in f32 and rounded once to ``dtype``, in one pass: no f32 copy
    of the stack is made."""
    if isinstance(w, dict) and "q" in w:
        out = torch.empty(w["q"].shape, dtype=dtype, device=w["q"].device)
        return torch.mul(w["q"], w["s"][..., None, :], out=out)
    return w


def _expert_ffn(x, w_gate, w_up, w_down, act: str, gated: bool):
    """x: [E, C, D]; weights: [E, D, F] / [E, F, D] (or int8 dicts)."""
    w_gate = _maybe_dequant(w_gate)
    w_up = _maybe_dequant(w_up)
    w_down = _maybe_dequant(w_down)
    dt = torch.promote_types(x.dtype, w_up.dtype)
    x = x.to(dt)
    up = torch.einsum("ecd,edf->ecf", x, w_up.to(dt))
    if gated:
        g = torch.einsum("ecd,edf->ecf", x, w_gate.to(dt))
        h = layers._act(g, act) * up
    else:
        h = layers._act(up, act)
    return torch.einsum("ecf,efd->ecd", h, w_down.to(dt))


def _router(xf, router_w, k: int):
    """xf: [T, D] -> (weights [T, k] f32, experts [T, k] int64, aux loss
    scalar f32).  f32 logits and softmax, the k largest probabilities
    renormalised by ``max(sum, 1e-9)``, and the Switch load-balance loss
    from each token's first choice.  Ties go to the lower expert, as
    ``jax.lax.top_k`` has them: a stable descending sort, where
    ``torch.topk`` leaves the order of ties open."""
    logits = xf.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                        # [T, E]
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    T, E = probs.shape
    me = probs.mean(dim=0)                                       # router frac
    # first-choice counts without a one-hot (or bincount, whose length
    # depends on the data under fake tensors)
    ce = torch.zeros(E, dtype=torch.float32, device=xf.device).scatter_add_(
        0, top_i[:, 0], torch.ones(T, dtype=torch.float32,
                                   device=xf.device)) / T
    aux = E * torch.sum(me * ce)
    return top_w, top_i, aux


def moe_apply_reference(x, params, cfg: ModelConfig):
    """x: [B, S, D] -> (y [B, S, D], aux).  The reference's exact masked
    combine over all E experts, accumulated in f32 (the plain version)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    xf = x.reshape(-1, D)
    top_w, top_i, aux = _router(xf, params["router"], k)
    out = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)

    def sl(w, e):
        if isinstance(w, dict):
            return {n: t[e:e + 1] for n, t in w.items()}
        return w[e:e + 1]

    w_g = params.get("w_gate")
    for e in range(E):
        h = _expert_ffn(xf[None], sl(w_g, e) if w_g is not None else None,
                        sl(params["w_up"], e), sl(params["w_down"], e),
                        cfg.act, cfg.gated_mlp)[0]
        gate = torch.where(top_i == e, top_w, 0.0).sum(dim=-1)
        out = out + gate[:, None] * h.float()
    return out.reshape(B, S, D).to(x.dtype), aux


def _grouped(x, w, ends):
    """Rows of ``x`` [N, K] (expert-contiguous; expert e owns rows
    ``ends[e-1]:ends[e]``) times their expert's ``w`` [E, K, M] -> [N, M].
    On fake tensors (the static verifier) only the shape is made: this
    torch's shape rule for ``_grouped_mm`` accepts bfloat16 alone, while
    its CPU and CUDA kernels take float32 too."""
    if isinstance(x, FakeTensor):
        return x.new_empty((x.shape[0], w.shape[-1]))
    return torch._grouped_mm(x, w, offs=ends)


def moe_apply(x, params, cfg: ModelConfig) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """x: [B, S, D] -> (y [B, S, D], aux): the served path, the same
    function as :func:`moe_apply_reference` (see the module docstring)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    xf = x.reshape(-1, D)
    T = xf.shape[0]
    top_w, top_i, aux = _router(xf, params["router"], k)
    flat_e = top_i.reshape(-1)                                   # [T*k]
    order = torch.argsort(flat_e, stable=True)      # pairs, by expert
    token = order // k
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    ends = torch.cumsum(counts, 0).to(torch.int32)
    rows = xf[token]                                             # [T*k, D]

    def stack(name):       # int8 experts: bf16 as in the reference, to x's
        return _maybe_dequant(params[name]).to(x.dtype)

    up = _grouped(rows, stack("w_up"), ends)
    if cfg.gated_mlp:
        h = layers._act(_grouped(rows, stack("w_gate"), ends), cfg.act) * up
    else:
        h = layers._act(up, cfg.act)
    del up
    out_rows = _grouped(h, stack("w_down"), ends)
    gate = top_w.reshape(-1)[order]
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    y.index_add_(0, token, gate[:, None] * out_rows.float())
    return y.reshape(B, S, D).to(x.dtype), aux

