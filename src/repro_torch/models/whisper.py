"""Whisper-medium transformer backbone, encoder-decoder (port of the
reference package's ``models/whisper.py``).  [arXiv:2212.04356]

The mel-spectrogram + conv frontend is a stub, as in the reference: the
caller supplies frame embeddings [B, encoder_seq, D] (``frames``; None
means zeros).  Positions are sinusoidal in the encoder and the decoder,
as in the reference.

Parameters keep the reference's layer-stacked layout (``enc/...`` and
``dec/...`` leaves carry the layer axis first), so bridged JAX params drop
straight in.  The decode cache is stacked over the decoder's layers: the
self-attention ring ``k``/``v`` [L, B, W, K, hd] with slot positions
``pos`` [L, B, W] (-1 = empty), and the encoder output's cross K/V
``ck``/``cv`` [L, B, encoder_seq, K, hd], which no decode step writes.

Attention stays plain PyTorch on both paths (chunked online softmax in the
prefill, single-token attention in decode), as in the reference, which
calls no Pallas kernel here.  The prefill builds its ring as the
reference does: when S > W it keeps positions S-W..S-1 at slots 0..W-1
but labels the slots 0..W-1.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.interop import torch_dtype
from repro_torch.models import layers
from repro_torch.models.partition import (AxisInfo, P, dp_axes, gather_fsdp,
                                          heads_spec, local_region, mp_axis,
                                          mp_size, replicated, reshard, rows,
                                          shard, vocab_table)

#: cache leaves a decode step reads and never writes (the cross K/V)
_READ_ONLY = ("ck", "cv")


def sinusoidal_positions(length: int, d: int, offset: int = 0,
                         device=None):
    """[length, d] f32: sin then cos of ``pos / 10000^(2i/d)``."""
    pos = torch.arange(offset, offset + length, dtype=torch.float32,
                       device=device)[:, None]
    return _sincos(pos, d)


def _sincos(pos, d: int):
    """pos: [N, 1] f32 -> [N, d]."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)[None]
    angle = pos / torch.pow(torch.tensor(10000.0, device=pos.device), dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, *, ax: Optional[AxisInfo] = None,
                **_unused) -> Dict[str, Any]:
    """Random weights with the reference's shapes and scales
    (``whisper.py:init_params``): normal(0, 1/sqrt(fan_in)) matrices,
    normal(0, 1/sqrt(d)) embedding, unit layernorm scales and zero biases.
    The draws come from ``generator`` (seed 0 when None) on ``device``;
    they are not the reference's ``jax.random`` draws.  Under a mesh the
    heads are padded and replicated to its model axis; ``device="meta"``
    gives shapes alone."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = torch_dtype(cfg.dtype)
    D, F, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    mp = mp_size(ax)
    Hp, Kp = cfg.padded_heads(mp), cfg.replicated_kv_heads(mp)

    def dense(shape, fan_in):
        return layers.dense_init(shape, dtype, fan_in=fan_in,
                                 generator=generator, device=dev)

    def norm(lead=()):
        return layers.init_norm(D, cfg.norm, dtype, dev, lead=lead)

    def attn(n):
        return {"wq": dense((n, D, Hp * hd), D),
                "wk": dense((n, D, Kp * hd), D),
                "wv": dense((n, D, Kp * hd), D),
                "wo": dense((n, Hp * hd, D), Hp * hd)}

    def mlp(n):
        return {"w_up": dense((n, D, F), D), "w_down": dense((n, F, D), F)}

    Le, Ld = cfg.encoder_layers, cfg.num_layers
    return {
        "embed": dense((cfg.padded_vocab, D), D),
        "enc": {"ln1": norm((Le,)), "attn": attn(Le), "ln2": norm((Le,)),
                "mlp": mlp(Le)},
        "enc_norm": norm(),
        "dec": {"ln1": norm((Ld,)), "attn": attn(Ld), "lnx": norm((Ld,)),
                "xattn": attn(Ld), "ln2": norm((Ld,)), "mlp": mlp(Ld)},
        "final_norm": norm(),
    }


# ---------------------------------------------------------------------------
# full-sequence pieces
# ---------------------------------------------------------------------------
def _divisor_chunk(s: int, target: int = 1024) -> int:
    """Largest chunk <= target that divides s (whisper's 1500 frames give
    750)."""
    for c in range(min(s, target), 0, -1):
        if s % c == 0:
            return c
    return s



def _mha_core(q, k, v, positions, *, cfg: ModelConfig, causal: bool,
              cross: bool):
    """The attention on one rank's heads; the kv is padded to a multiple
    of its chunk with positions -1.  Returns (out, k, v), k and v
    padded."""
    S = q.shape[1]
    kpos = (torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
            if cross else positions)
    chunk = _divisor_chunk(S)
    ck = min(1024, k.shape[1])
    pad = (-k.shape[1]) % ck
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = torch.cat([kpos, torch.full((pad,), -1, dtype=torch.int32,
                                           device=q.device)])
    qpos = positions if causal else torch.zeros(
        (S,), dtype=torch.int32, device=q.device)
    out = layers.chunked_attention(
        q, k, v, q_positions=qpos, k_positions=kpos, causal=causal,
        chunk_q=chunk, chunk_k=ck, scale=1.0 / math.sqrt(cfg.head_dim))
    return out, k, v


def _mha_full(x, ap, cfg: ModelConfig, positions, *, kv=None,
              causal: bool = True, ax=None):
    """Self (``kv`` None) or cross attention over full sequences; the kv
    is padded to a multiple of its chunk with positions -1.  Returns
    (out, (k, v)), k and v padded."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    mp = mp_size(ax)
    Hp, Kp = cfg.padded_heads(mp), cfg.replicated_kv_heads(mp)
    x = rows(ax, x)
    q = (x @ ap["wq"]).reshape(B, S, Hp, hd)
    if kv is None:
        k = (x @ ap["wk"]).reshape(B, S, Kp, hd)
        v = (x @ ap["wv"]).reshape(B, S, Kp, hd)
    else:
        k, v = kv
    hs = heads_spec(ax)
    q = shard(ax, q, *hs)
    k, v = (reshard(ax, t, *hs) for t in (k, v))
    core = functools.partial(_mha_core, cfg=cfg, causal=causal,
                             cross=kv is not None)
    out, k, v = local_region(ax, core, (hs, hs, hs, None), (hs, hs, hs))(
        q, k, v, positions)
    return out.reshape(B, S, -1) @ ap["wo"], (k, v)


def encode(params, frames, cfg: ModelConfig, ax=None):
    """frames: [B, T_enc, D] stub embeddings -> the encoder's output
    (differentiable; never rematerialised, as in the reference)."""
    B, T, D = frames.shape
    x = frames + replicated(sinusoidal_positions(
        T, D, device=frames.device).to(frames.dtype), frames)
    x = shard(ax, x, dp_axes(ax), None, None)
    positions = torch.arange(T, dtype=torch.int32, device=frames.device)
    for j in range(cfg.encoder_layers):
        lp = gather_fsdp(ax, layers.layer_slice(params["enc"], j))
        h = layers.apply_norm(x, lp["ln1"], cfg.norm)
        a, _ = _mha_full(h, lp["attn"], cfg, positions, causal=False, ax=ax)
        x = x + rows(ax, a)
        h = layers.apply_norm(x, lp["ln2"], cfg.norm)
        x = x + rows(ax, layers.mlp_apply(rows(ax, h), lp["mlp"],
                                          gated=cfg.gated_mlp, act=cfg.act))
    return layers.apply_norm(x, params["enc_norm"], cfg.norm)


def _cache_core(k, v, *, S: int, W: int):
    """One layer's prefill cache on one rank's rows and heads: the first
    S keys in a ring of W slots (the last W when S >= W)."""
    B = k.shape[0]
    if S >= W:
        ks, vs = k[:, S - W:S], v[:, S - W:S]
    else:
        ks = torch.nn.functional.pad(k[:, :S], (0, 0, 0, 0, 0, W - S))
        vs = torch.nn.functional.pad(v[:, :S], (0, 0, 0, 0, 0, W - S))
    slots = torch.arange(W, dtype=torch.int32, device=k.device)
    return ks, vs, torch.where(slots < S, slots, -1).expand(B, W)


def forward(params, tokens, cfg: ModelConfig, *, ax: Optional[AxisInfo] = None,
            frames=None, build_cache: bool = False,
            cache_len: Optional[int] = None, remat: bool = False,
            with_aux: bool = False, **_unused):
    """tokens: [B, S] decoder input; frames: [B, T_enc, D] stub embeddings
    (zeros when None, as in the reference) -> logits [B, S, V], with
    ``build_cache`` also the decode cache, and with ``with_aux`` a zero
    f32 aux loss.  ``remat`` checkpoints each decoder layer (the
    reference's plain ``jax.checkpoint``; the encoder is not).
    Differentiable: the caller picks grad mode."""
    B, S = tokens.shape
    dev = tokens.device
    table = vocab_table(params, ax)
    if frames is None:
        frames = torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                             dtype=torch_dtype(cfg.dtype), device=dev)
        frames = replicated(frames, table)
    enc_out = encode(params, frames, cfg, ax)
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    dp, mp = dp_axes(ax), mp_axis(ax)
    # the vocab-parallel lookup's partial sums, reduced into the
    # residual's layout before the positions are added
    x = reshard(ax, layers.embed_lookup(table, tokens), dp, mp, None)
    x = x + replicated(sinusoidal_positions(S, cfg.d_model, device=dev).to(
        x.dtype), x)
    x = shard(ax, x, dp, mp, None)
    Kp, hd = cfg.replicated_kv_heads(mp_size(ax)), cfg.head_dim
    enc_rows = rows(ax, enc_out)

    def layer(x, enc_out, lp):
        lp = gather_fsdp(ax, lp)
        x = shard(ax, x, dp, mp, None)
        h = layers.apply_norm(x, lp["ln1"], cfg.norm)
        a, (k, v) = _mha_full(h, lp["attn"], cfg, positions, causal=True,
                              ax=ax)
        x = x + rows(ax, a)
        h = layers.apply_norm(x, lp["lnx"], cfg.norm)
        ek = (enc_out @ lp["xattn"]["wk"]).reshape(B, -1, Kp, hd)
        ev = (enc_out @ lp["xattn"]["wv"]).reshape(B, -1, Kp, hd)
        a, _ = _mha_full(h, lp["xattn"], cfg, positions, kv=(ek, ev),
                         causal=False, ax=ax)
        x = x + rows(ax, a)
        h = layers.apply_norm(x, lp["ln2"], cfg.norm)
        x = x + rows(ax, layers.mlp_apply(rows(ax, h), lp["mlp"],
                                          gated=cfg.gated_mlp, act=cfg.act))
        cache = {}
        if build_cache:
            hs = heads_spec(ax)
            core = functools.partial(_cache_core, S=S, W=cache_len or S)
            ks, vs, ps = local_region(ax, core, (hs, hs),
                                      (hs, hs, P(dp, None)))(k, v)
            cache = {"k": ks, "v": vs, "pos": ps, "ck": ek, "cv": ev}
        return x, cache

    body = layers.remat_block(layer) if remat else layer
    caches: Dict[str, list] = {}
    for j in range(cfg.num_layers):
        x, cache = body(x, enc_rows, layers.layer_slice(params["dec"], j))
        for name, t in cache.items():
            caches.setdefault(name, []).append(t)
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    logits = layers.unembed(rows(ax, x), table)
    logits = shard(ax, logits, dp, mp, None)
    out = (logits,)
    if build_cache:
        out += ({k: torch.stack(v) for k, v in caches.items()},)
    if with_aux:
        out += (x.new_zeros((), dtype=torch.float32),)
    return out if len(out) > 1 else logits


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: DeviceLike = None, *, ax: Optional[AxisInfo] = None,
               **_unused):
    """Empty decode cache: zero K/V, -1 positions and zero cross K/V of
    ``encoder_seq`` rows.  ``device="meta"`` gives shapes and dtypes
    without allocating."""
    dev = resolve_device(device)
    Kp, hd = cfg.replicated_kv_heads(mp_size(ax)), cfg.head_dim
    L, M = cfg.num_layers, cfg.encoder_seq
    dtype = torch_dtype(cfg.dtype)
    return {
        "k": torch.zeros((L, batch, cache_len, Kp, hd), dtype=dtype,
                         device=dev),
        "v": torch.zeros((L, batch, cache_len, Kp, hd), dtype=dtype,
                         device=dev),
        "pos": torch.full((L, batch, cache_len), -1, dtype=torch.int32,
                          device=dev),
        "ck": torch.zeros((L, batch, M, Kp, hd), dtype=dtype, device=dev),
        "cv": torch.zeros((L, batch, M, Kp, hd), dtype=dtype, device=dev),
    }


def cache_pspecs(cfg: ModelConfig, ax: AxisInfo, **_unused):
    """Partition specs matching :func:`init_cache`: batch over data, KV
    heads over model."""
    dp, mp = ax.batch, ax.model
    return {"k": P(None, dp, None, mp, None),
            "v": P(None, dp, None, mp, None),
            "pos": P(None, dp, None),
            "ck": P(None, dp, None, mp, None),
            "cv": P(None, dp, None, mp, None)}


def _step_core(q, k, v, pos, kc, vc, pc, *, scale: float):
    """The ring write at slot ``pos % W`` (IN PLACE) and the attention
    of one decode step, on one rank's rows and heads."""
    b_idx = torch.arange(q.shape[0], device=q.device)
    slot = (pos % kc.shape[1]).long()
    kc[b_idx, slot] = k[:, 0]
    vc[b_idx, slot] = v[:, 0]
    pc[b_idx, slot] = pos.to(pc.dtype)
    return (layers.decode_attention(q, kc, vc, q_position=pos,
                                    k_positions=pc, scale=scale),)


def _cross_step_core(q, ck, cv, *, scale: float):
    B, M = ck.shape[0], ck.shape[1]
    cross_pos = torch.arange(M, dtype=torch.int32,
                             device=q.device).expand(B, M)
    cross_q = torch.full((B,), M, dtype=torch.int32, device=q.device)
    return (layers.decode_attention(q, ck, cv, q_position=cross_q,
                                    k_positions=cross_pos, scale=scale),)


def _pos_enc(pos, *, d: int):
    """Each row's sinusoid at its decode position: [B] -> [B, 1, d]."""
    return (_sincos(pos.float()[:, None], d)[:, None],)


@torch.no_grad()
def decode_step(params, tokens, pos, cache, cfg: ModelConfig, *,
                ax: Optional[AxisInfo] = None, **_unused):
    """tokens: [B, 1]; pos: [B] absolute position of the new token.
    Returns (logits [B, 1, V], new_cache).  The step writes its new slots
    into a copy of ``k``/``v``/``pos`` (the input cache is left as it
    was); ``ck``/``cv``, which no step writes, are passed on as they
    are."""
    B = tokens.shape[0]
    mp = mp_size(ax)
    Hp, Kp = cfg.padded_heads(mp), cfg.replicated_kv_heads(mp)
    hd = cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    new_cache = {k: v if k in _READ_ONLY else v.clone()
                 for k, v in cache.items()}
    dp, hs = dp_axes(ax), heads_spec(ax)
    table = vocab_table(params, ax)
    x = reshard(ax, layers.embed_lookup(table, tokens), dp, None, None)
    pos = reshard(ax, pos, dp)
    # sinusoidal at each row's decode position
    (pe,) = local_region(ax, functools.partial(_pos_enc, d=cfg.d_model),
                         (P(dp),), (P(dp, None, None),))(pos)
    x = x + pe.to(x.dtype)
    x = shard(ax, x, dp, None, None)
    step = functools.partial(_step_core, scale=scale)
    cross = functools.partial(_cross_step_core, scale=scale)
    for j in range(cfg.num_layers):
        lp = gather_fsdp(ax, layers.layer_slice(params["dec"], j))
        kc, vc, pc = (new_cache[n][j] for n in ("k", "v", "pos"))
        h = layers.apply_norm(x, lp["ln1"], cfg.norm)
        q = (h @ lp["attn"]["wq"]).reshape(B, 1, Hp, hd)
        k = (h @ lp["attn"]["wk"]).reshape(B, 1, Kp, hd)
        v = (h @ lp["attn"]["wv"]).reshape(B, 1, Kp, hd)
        q, k, v = (reshard(ax, t, *hs) for t in (q, k, v))
        (a,) = local_region(ax, step, (hs, hs, hs, P(dp), hs, hs,
                                       P(dp, None)), (hs,))(
            q, k, v, pos, kc, vc, pc)
        x = x + a.reshape(B, 1, -1) @ lp["attn"]["wo"]
        h = layers.apply_norm(x, lp["lnx"], cfg.norm)
        qx = reshard(ax, (h @ lp["xattn"]["wq"]).reshape(B, 1, Hp, hd), *hs)
        (a,) = local_region(ax, cross, (hs, hs, hs), (hs,))(
            qx, new_cache["ck"][j], new_cache["cv"][j])
        x = x + a.reshape(B, 1, -1) @ lp["xattn"]["wo"]
        h = layers.apply_norm(x, lp["ln2"], cfg.norm)
        x = x + layers.mlp_apply(h, lp["mlp"], gated=cfg.gated_mlp,
                                 act=cfg.act)
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    logits = layers.unembed(rows(ax, x), table)
    return logits, new_cache
