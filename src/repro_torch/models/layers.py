"""Shared layers of the model zoo (port of the reference package's
``models/layers.py``, the subset the ported families need).

Plain functions over tensors, numerically the reference's: rmsnorm in the
``(1 + scale)`` form with zero-initialised scale, layernorm, RWKV-6's
per-head group norm (population variance, eps 64e-5), half-split (not
interleaved) RoPE, KV-chunked online-softmax attention with masked logits
at -1e30, single-token decode attention over a ring cache, and the int8
KV-cache quantization of ``kv_quant``, and per-block rematerialisation
(``remat_block``) for the training forward.  The CUDA kernels in
:mod:`repro_torch.kernels` replace the two attention functions when
``use_kernels`` is set.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dtype)


def apply_norm(x, params, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])


def init_norm(d: int, kind: str, dtype, device, lead=()):
    """A norm's parameters (the reference's ``init_norm``): rmsnorm a zero
    ``scale`` (it scales by ``1 + scale``), layernorm unit ``scale`` and
    zero ``bias``; ``lead`` prepends stacked axes."""
    shape = tuple(lead) + (d,)
    if kind == "rmsnorm":
        return {"scale": torch.zeros(shape, dtype=dtype, device=device)}
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


def groupnorm_heads(x, scale, bias, num_heads: int, eps: float = 64e-5):
    """GroupNorm over per-head channels (RWKV6 time-mix output norm)."""
    b, t, d = x.shape
    xs = x.float().reshape(b, t, num_heads, d // num_heads)
    mu = torch.mean(xs, dim=-1, keepdim=True)
    var = torch.var(xs, dim=-1, keepdim=True, correction=0)
    xs = ((xs - mu) * torch.rsqrt(var + eps)).reshape(b, t, d)
    return (xs * scale.float() + bias.float()).to(x.dtype)


def _save_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    outputs of matrix products without batch dims (``aten.mm`` and
    ``aten.addmm``: ``x @ W`` on a [B, S, D] ``x`` folds to one), recompute
    the rest (JAX's ``checkpoint_dots_with_no_batch_dims``)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_block(fn, policy: str = "nothing"):
    """``fn`` under per-block rematerialisation, as the reference's
    ``jax.checkpoint(block_fn, policy=...)``: ``"nothing"`` saves only the
    block's inputs and recomputes the whole block in the backward pass,
    ``"dots"`` also saves the matrix products' outputs
    (:func:`_save_products`), ``"everything"`` saves all (``fn`` itself).
    Non-reentrant checkpointing, so ``fn`` may take and return nested
    structures."""
    if policy == "everything":
        return fn
    if policy not in ("nothing", "dots"):
        raise ValueError(f"unknown remat_policy {policy!r} (nothing | dots "
                         "| everything)")
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_products)

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def layer_slice(tree, j: int):
    """Layer (or block) ``j`` of layer-stacked params or caches: index the
    leading axis of every leaf (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, j) for k, v in tree.items()}
    return tree[j]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # [hd/2]


def apply_rope(x, positions, theta: float, freqs=None):
    """x: [..., S, n_heads, head_dim]; positions: [S] or [B, S] int32.
    Half-split rotation: the first half of head_dim pairs with the
    second.  ``freqs``: ``rope_frequencies(head_dim, theta)`` where the
    caller keeps it built (``theta`` is then not read); without it no
    rotation at ``theta <= 0``."""
    if freqs is None:
        if theta <= 0.0:
            return x
        freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions.float()[..., None] * freqs        # [(B,)S,hd/2]
    angles = angles.unsqueeze(-2)                        # [(B,)S,1,hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (chunked online-softmax; GQA; sliding window; logit softcap)
# ---------------------------------------------------------------------------
NEG_INF = -1e30


def _softcap(logits, cap: float):
    if cap and cap > 0.0:
        return cap * torch.tanh(logits / cap)
    return logits


def _mask_logits(logits, q_pos, k_pos, *, causal: bool, window: int):
    """logits: [..., Q, Kc]; q_pos: [..., Q]; k_pos: [..., Kc] (-1 = invalid)."""
    valid = (k_pos >= 0)[..., None, :]
    if causal:
        valid = valid & (k_pos[..., None, :] <= q_pos[..., :, None])
    if window and window > 0:
        valid = valid & (q_pos[..., :, None] - k_pos[..., None, :] < window)
    return torch.where(valid, logits, torch.full_like(logits, NEG_INF))


def chunked_attention(q, k, v, *, q_positions, k_positions,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0, chunk_q: int = 1024,
                      chunk_k: int = 1024, scale: Optional[float] = None):
    """Flash-style attention without O(Sq*Sk) live memory.

    q: [B, Sq, H, hd];  k, v: [B, Sk, K, hd] with H = K*G (GQA).
    q_positions: [Sq] or [B, Sq]; k_positions: [Sk] or [B, Sk] (-1 invalid).
    Returns [B, Sq, H, hd].

    One online-softmax pass over the key chunks, every query row at once:
    each row meets the key chunks in the reference's order, so each row's
    arithmetic is the reference's, whose scan takes the query chunks one
    after another.  Live memory is O(Sq * chunk_k); the query loop of
    the reference would cost Sq / chunk_q times the ops in eager mode
    (and in the dry-run's trace).  ``chunk_q`` must still divide Sq, as
    in the reference.
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    cq = min(chunk_q, Sq)
    ck = min(chunk_k, Sk)
    if Sq % cq or Sk % ck:
        raise ValueError(f"chunks must divide: Sq={Sq} cq={cq} Sk={Sk} "
                         f"ck={ck}")
    if q_positions.dim() == 1:
        q_positions = q_positions[None].expand(B, Sq)
    if k_positions.dim() == 1:
        k_positions = k_positions[None].expand(B, Sk)

    # [B, K, G, Sq, hd]
    q_all = q.reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4).float()
    qpos = q_positions[:, None, None, :]
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, Sk, ck):
        k_blk = k[:, k0:k0 + ck].permute(0, 2, 1, 3).float()
        v_blk = v[:, k0:k0 + ck].permute(0, 2, 1, 3).float()
        kpos = k_positions[:, k0:k0 + ck]
        logits = torch.einsum("bkgqd,bkcd->bkgqc", q_all, k_blk) * scale
        logits = _softcap(logits, softcap)
        logits = _mask_logits(logits, qpos, kpos[:, None, None, :],
                              causal=causal, window=window)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqc,bkcd->bkgqd", p, v_blk)
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def decode_attention(q, k_cache, v_cache, *, q_position, k_positions,
                     window: int = 0, softcap: float = 0.0,
                     scale: Optional[float] = None):
    """Single-token attention against a (possibly ring-buffer) KV cache.

    q: [B, 1, H, hd]; k_cache/v_cache: [B, S, K, hd];
    q_position: [B] int32; k_positions: [B, S] int32 (-1 = empty slot).
    """
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qh = q.reshape(B, K, G, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qh.float(),
                          k_cache.float()) * scale
    logits = _softcap(logits, softcap)
    valid = (k_positions >= 0) & (k_positions <= q_position[:, None])
    if window and window > 0:
        valid = valid & (q_position[:, None] - k_positions < window)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# int8 KV-cache quantization (``kv_quant``)
# ---------------------------------------------------------------------------
def kv_quantize(x):
    """x: [..., hd] -> (int8 values, f32 scale [...]), one scale per
    (slot, head): ``max(|x|) / 127`` (at least 1e-8 / 127), values
    rounded half to even and clipped to +-127, all in f32."""
    xf = x.float()
    amax = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can miss max / 127 by a last
    # bit (and then flip a rounded value); a tensor divides exactly
    scale = amax / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def kv_dequantize(q, scale, dtype=torch.bfloat16):
    """int8 values and their f32 scales back to ``dtype`` (f32 math)."""
    return (q.float() * scale[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def _act(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def mlp_apply(x, params, *, gated: bool, act: str):
    if gated:
        h = _act(x @ params["w_gate"], act) * (x @ params["w_up"])
    else:
        h = _act(x @ params["w_up"], act)
    return h @ params["w_down"]


def dense_init(shape, dtype, *, fan_in: int, generator: torch.Generator,
               device):
    """Normal(0, 1/sqrt(fan_in)) in float32, cast to ``dtype`` (the
    reference's ``dense_init`` scale).  On the meta device only the shape
    and dtype are made."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    std = 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w.mul_(std)).to(dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_lookup(table, tokens, *, scale_by_dim: bool = False):
    out = F.embedding(tokens.long(), table)
    if scale_by_dim:
        out = out * math.sqrt(table.shape[-1])
    return out


def unembed(x, table, *, softcap: float = 0.0):
    logits = torch.einsum("...d,vd->...v", x, table).float()
    return _softcap(logits, softcap)
