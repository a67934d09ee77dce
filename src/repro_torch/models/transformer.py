"""Decoder-only dense transformer (port of the reference package's
``models/transformer.py``, dense family: yi, glm4, granite).

Parameters keep the reference's layer-stacked layout (``blocks/"0"/...``
leaves carry the block axis first), so bridged JAX params drop straight
in; a Python loop over that axis replaces ``lax.scan``.  KV caches are
stacked the same way: ``k0``/``v0`` ``[n_blocks, B, W, K, hd]`` ring
buffers and ``pos0`` ``[n_blocks, B, W]`` slot positions (-1 = empty).

``cfg.use_kernels`` selects the CUDA kernels at the two attention sites
(the prefill's flash attention and the decode step's decode attention);
on CPU tensors the kernel wrappers run their plain versions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.interop import torch_dtype
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    window: int = 0            # 0 = full attention


#: config fields that change the reference's dense layout, cache or math
#: and that this module does not read yet: field -> its default
UNPORTED_FIELDS = {"kv_quant": False, "local_global_pattern": 0,
                   "post_norms": False, "num_experts": 0,
                   "moe_layer_period": 1}


def block_layout(cfg: ModelConfig) -> Tuple[List[LayerSpec], int]:
    """Return (specs for one block, n_blocks).  Dense only; a config that
    sets a field of ``UNPORTED_FIELDS`` raises rather than being served
    as if the field were unset."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    unported = {f: getattr(cfg, f) for f, default in UNPORTED_FIELDS.items()
                if getattr(cfg, f) != default}
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: config fields {unported} are not ported yet")
    return [LayerSpec()], cfg.num_layers


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random weights with the reference's shapes and scales
    (``transformer.py:init_params``): normal(0, 1/sqrt(fan_in)) matrices,
    normal(0, 1/sqrt(d)) embedding, zero rmsnorm scales.  The draws come
    from ``generator`` (seed 0 when None) on ``device``; they are not the
    reference's ``jax.random`` draws — bridge those with
    :func:`repro_torch.interop.params_from_numpy`."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = torch_dtype(cfg.dtype)
    specs, n = block_layout(cfg)
    D, hd, F = cfg.d_model, cfg.head_dim, cfg.d_ff
    Hp, Kp = cfg.padded_heads(1), cfg.replicated_kv_heads(1)

    def dense(shape, fan_in):
        return layers.dense_init(shape, dtype, fan_in=fan_in,
                                 generator=generator, device=dev)

    params: Dict[str, Any] = {
        "embed": dense((cfg.padded_vocab, D), D),
        "final_norm": {"scale": torch.zeros((D,), dtype=dtype, device=dev)},
        "blocks": {},
    }
    for i, _spec in enumerate(specs):
        mlp = {"w_up": dense((n, D, F), D), "w_down": dense((n, F, D), F)}
        if cfg.gated_mlp:
            mlp["w_gate"] = dense((n, D, F), D)
        params["blocks"][str(i)] = {
            "ln1": {"scale": torch.zeros((n, D), dtype=dtype, device=dev)},
            "attn": {"wq": dense((n, D, Hp * hd), D),
                     "wk": dense((n, D, Kp * hd), D),
                     "wv": dense((n, D, Kp * hd), D),
                     "wo": dense((n, Hp * hd, D), Hp * hd)},
            "ln2": {"scale": torch.zeros((n, D), dtype=dtype, device=dev)},
            "mlp": mlp,
        }
    return params


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------
def _attn_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.head_dim)


def project_qkv(x, ap, cfg: ModelConfig):
    B, S, _ = x.shape
    hd = cfg.head_dim
    Hp, Kp = cfg.padded_heads(1), cfg.replicated_kv_heads(1)
    q = (x @ ap["wq"]).reshape(B, S, Hp, hd)
    k = (x @ ap["wk"]).reshape(B, S, Kp, hd)
    v = (x @ ap["wv"]).reshape(B, S, Kp, hd)
    return q, k, v


def _self_attention_full(x, ap, cfg: ModelConfig, spec: LayerSpec,
                         positions, chunk: int = 1024):
    """Full-sequence (prefill) self attention.  Returns (out, k, v)."""
    q, k, v = project_qkv(x, ap, cfg)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    if cfg.use_kernels:
        from repro_torch.kernels import ops as kops
        # [B,S,H,hd] -> [B,H,S,hd] views: the kernel reads strides
        out = kops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=spec.window,
            softcap=cfg.attn_logit_softcap, scale=_attn_scale(cfg),
        ).transpose(1, 2)
    else:
        out = layers.chunked_attention(
            q, k, v, q_positions=positions, k_positions=positions,
            causal=True, window=spec.window,
            softcap=cfg.attn_logit_softcap,
            chunk_q=chunk, chunk_k=chunk, scale=_attn_scale(cfg))
    out = out.reshape(x.shape[0], x.shape[1], -1) @ ap["wo"]
    return out, k, v


def _self_attention_decode(x, ap, cfg: ModelConfig, spec: LayerSpec, pos,
                           kc, vc, pc):
    """One-token decode.  x: [B,1,D]; kc/vc: [B,W,Kp,hd] and pc: [B,W]
    slot positions (-1 = empty) — this layer's slices of the decode
    step's private cache copy, written IN PLACE (the caller cloned the
    cache, so the table columns it came from are never touched).
    pos: [B].  Returns out."""
    q, k, v = project_qkv(x, ap, cfg)
    q = layers.apply_rope(q, pos[:, None], cfg.rope_theta)
    k = layers.apply_rope(k, pos[:, None], cfg.rope_theta)
    W = kc.shape[1]
    slot = (pos % W).long()                                       # [B]
    b_idx = torch.arange(x.shape[0], device=x.device)
    kc[b_idx, slot] = k[:, 0]
    vc[b_idx, slot] = v[:, 0]
    pc[b_idx, slot] = pos.to(pc.dtype)
    if cfg.use_kernels:
        from repro_torch.kernels import ops as kops
        # [B,W,K,hd] -> [B,K,W,hd] is a view; the kernel reads strides
        out = kops.decode_attention(
            q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), pc,
            pos.to(torch.int32), window=spec.window,
            softcap=cfg.attn_logit_softcap,
            scale=_attn_scale(cfg))[:, None]
    else:
        out = layers.decode_attention(
            q, kc, vc, q_position=pos, k_positions=pc,
            window=spec.window, softcap=cfg.attn_logit_softcap,
            scale=_attn_scale(cfg))
    return out.reshape(x.shape[0], 1, -1) @ ap["wo"]


def _ffn(x, lp, cfg: ModelConfig):
    return layers.mlp_apply(x, lp["mlp"], gated=cfg.gated_mlp, act=cfg.act)


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------
@torch.no_grad()
def forward(params, tokens, cfg: ModelConfig, *, build_cache: bool = False,
            cache_len: Optional[int] = None, chunk: int = 1024):
    """tokens: [B, S] -> logits [B, S, V].  If ``build_cache`` also returns
    the decode cache (prefill) with ring semantics: a layer of window W
    keeps the last W positions when S >= W, else pads with -1 slots."""
    specs, n_blocks = block_layout(cfg)
    B, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    x = layers.embed_lookup(params["embed"], tokens,
                            scale_by_dim=cfg.embedding_scale)
    caches: Dict[str, List[torch.Tensor]] = {}
    for j in range(n_blocks):
        blk = layers.layer_slice(params["blocks"], j)
        for i, spec in enumerate(specs):
            lp = blk[str(i)]
            h = layers.apply_norm(x, lp["ln1"], cfg.norm)
            attn_out, k, v = _self_attention_full(h, lp["attn"], cfg, spec,
                                                  positions, chunk=chunk)
            x = x + attn_out
            h = layers.apply_norm(x, lp["ln2"], cfg.norm)
            x = x + _ffn(h, lp, cfg)
            if build_cache:
                W = spec.window if spec.window else (cache_len or S)
                W = min(W, cache_len or S)
                if S >= W:
                    ks, vs = k[:, S - W:], v[:, S - W:]
                    ps = positions[S - W:].expand(B, W)
                else:
                    pad = W - S
                    ks = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
                    vs = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
                    ps = torch.cat([positions, torch.full(
                        (pad,), -1, dtype=torch.int32, device=dev)]
                    ).expand(B, W)
                caches.setdefault(f"k{i}", []).append(ks)
                caches.setdefault(f"v{i}", []).append(vs)
                caches.setdefault(f"pos{i}", []).append(ps)
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    logits = layers.unembed(x, params["embed"],
                            softcap=cfg.final_logit_softcap)
    if build_cache:
        return logits, {k: torch.stack(v) for k, v in caches.items()}
    return logits


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: DeviceLike = None):
    """Empty decode cache (stacked over blocks).  ``device="meta"`` gives
    shapes and dtypes without allocating."""
    dev = resolve_device(device)
    specs, n_blocks = block_layout(cfg)
    Kp, hd = cfg.replicated_kv_heads(1), cfg.head_dim
    dtype = torch_dtype(cfg.dtype)
    cache = {}
    for i, spec in enumerate(specs):
        W = min(spec.window, cache_len) if spec.window else cache_len
        cache[f"k{i}"] = torch.zeros((n_blocks, batch, W, Kp, hd),
                                     dtype=dtype, device=dev)
        cache[f"v{i}"] = torch.zeros((n_blocks, batch, W, Kp, hd),
                                     dtype=dtype, device=dev)
        cache[f"pos{i}"] = torch.full((n_blocks, batch, W), -1,
                                      dtype=torch.int32, device=dev)
    return cache


@torch.no_grad()
def decode_step(params, tokens, pos, cache, cfg: ModelConfig):
    """tokens: [B, 1]; pos: [B] absolute position of the new token.
    Returns (logits [B, 1, V], new_cache).  The input cache is left as it
    was: the step writes its new slots into a copy (the reference's
    ``.at[].set`` is functional, and the cache tensors may be views of
    table columns that other consumers share)."""
    specs, n_blocks = block_layout(cfg)
    new_cache = {k: v.clone() for k, v in cache.items()}
    x = layers.embed_lookup(params["embed"], tokens,
                            scale_by_dim=cfg.embedding_scale)
    for j in range(n_blocks):
        blk = layers.layer_slice(params["blocks"], j)
        for i, spec in enumerate(specs):
            lp = blk[str(i)]
            h = layers.apply_norm(x, lp["ln1"], cfg.norm)
            x = x + _self_attention_decode(
                h, lp["attn"], cfg, spec, pos, new_cache[f"k{i}"][j],
                new_cache[f"v{i}"][j], new_cache[f"pos{i}"][j])
            h = layers.apply_norm(x, lp["ln2"], cfg.norm)
            x = x + _ffn(h, lp, cfg)
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    logits = layers.unembed(x, params["embed"],
                            softcap=cfg.final_logit_softcap)
    return logits, new_cache
