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

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.interop import torch_dtype
from repro_torch.models import layers

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
                device: DeviceLike = None, **_unused) -> Dict[str, Any]:
    """Random weights with the reference's shapes and scales
    (``whisper.py:init_params``): normal(0, 1/sqrt(fan_in)) matrices,
    normal(0, 1/sqrt(d)) embedding, unit layernorm scales and zero biases.
    The draws come from ``generator`` (seed 0 when None) on ``device``;
    they are not the reference's ``jax.random`` draws."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = torch_dtype(cfg.dtype)
    D, F, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    Hp, Kp = cfg.padded_heads(1), cfg.replicated_kv_heads(1)

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


def _mha_full(x, ap, cfg: ModelConfig, positions, *, kv=None,
              causal: bool = True):
    """Self (``kv`` None) or cross attention over full sequences; the kv
    is padded to a multiple of its chunk with positions -1.  Returns
    (out, (k, v)), k and v padded."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    Hp, Kp = cfg.padded_heads(1), cfg.replicated_kv_heads(1)
    q = (x @ ap["wq"]).reshape(B, S, Hp, hd)
    if kv is None:
        k = (x @ ap["wk"]).reshape(B, S, Kp, hd)
        v = (x @ ap["wv"]).reshape(B, S, Kp, hd)
        kpos = positions
    else:
        k, v = kv
        kpos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
    chunk = _divisor_chunk(S)
    ck = min(1024, k.shape[1])
    pad = (-k.shape[1]) % ck
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = torch.cat([kpos, torch.full((pad,), -1, dtype=torch.int32,
                                           device=x.device)])
    qpos = positions if causal else torch.zeros(
        (S,), dtype=torch.int32, device=x.device)
    out = layers.chunked_attention(
        q, k, v, q_positions=qpos, k_positions=kpos, causal=causal,
        chunk_q=chunk, chunk_k=ck, scale=1.0 / math.sqrt(hd))
    return out.reshape(B, S, -1) @ ap["wo"], (k, v)


def encode(params, frames, cfg: ModelConfig):
    """frames: [B, T_enc, D] stub embeddings -> the encoder's output
    (differentiable; never rematerialised, as in the reference)."""
    B, T, D = frames.shape
    x = frames + sinusoidal_positions(T, D, device=frames.device).to(
        frames.dtype)
    positions = torch.arange(T, dtype=torch.int32, device=frames.device)
    for j in range(cfg.encoder_layers):
        lp = layers.layer_slice(params["enc"], j)
        h = layers.apply_norm(x, lp["ln1"], cfg.norm)
        a, _ = _mha_full(h, lp["attn"], cfg, positions, causal=False)
        x = x + a
        h = layers.apply_norm(x, lp["ln2"], cfg.norm)
        x = x + layers.mlp_apply(h, lp["mlp"], gated=cfg.gated_mlp,
                                 act=cfg.act)
    return layers.apply_norm(x, params["enc_norm"], cfg.norm)


def forward(params, tokens, cfg: ModelConfig, *, frames=None,
            build_cache: bool = False, cache_len: Optional[int] = None,
            remat: bool = False, with_aux: bool = False, **_unused):
    """tokens: [B, S] decoder input; frames: [B, T_enc, D] stub embeddings
    (zeros when None, as in the reference) -> logits [B, S, V], with
    ``build_cache`` also the decode cache, and with ``with_aux`` a zero
    f32 aux loss.  ``remat`` checkpoints each decoder layer (the
    reference's plain ``jax.checkpoint``; the encoder is not).
    Differentiable: the caller picks grad mode."""
    B, S = tokens.shape
    dev = tokens.device
    if frames is None:
        frames = torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                             dtype=torch_dtype(cfg.dtype), device=dev)
    enc_out = encode(params, frames, cfg)
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    x = layers.embed_lookup(params["embed"], tokens)
    x = x + sinusoidal_positions(S, cfg.d_model, device=dev).to(x.dtype)
    Kp, hd = cfg.replicated_kv_heads(1), cfg.head_dim

    def layer(x, enc_out, lp):
        h = layers.apply_norm(x, lp["ln1"], cfg.norm)
        a, (k, v) = _mha_full(h, lp["attn"], cfg, positions, causal=True)
        x = x + a
        h = layers.apply_norm(x, lp["lnx"], cfg.norm)
        ek = (enc_out @ lp["xattn"]["wk"]).reshape(B, -1, Kp, hd)
        ev = (enc_out @ lp["xattn"]["wv"]).reshape(B, -1, Kp, hd)
        a, _ = _mha_full(h, lp["xattn"], cfg, positions, kv=(ek, ev),
                         causal=False)
        x = x + a
        h = layers.apply_norm(x, lp["ln2"], cfg.norm)
        x = x + layers.mlp_apply(h, lp["mlp"], gated=cfg.gated_mlp,
                                 act=cfg.act)
        cache = {}
        if build_cache:
            W = cache_len or S
            if S >= W:
                ks, vs = k[:, S - W:S], v[:, S - W:S]
            else:
                ks = torch.nn.functional.pad(k[:, :S],
                                             (0, 0, 0, 0, 0, W - S))
                vs = torch.nn.functional.pad(v[:, :S],
                                             (0, 0, 0, 0, 0, W - S))
            slots = torch.arange(W, dtype=torch.int32, device=dev)
            ps = torch.where(slots < S, slots, -1)
            cache = {"k": ks, "v": vs, "pos": ps.expand(B, W), "ck": ek,
                     "cv": ev}
        return x, cache

    body = layers.remat_block(layer) if remat else layer
    caches: Dict[str, list] = {}
    for j in range(cfg.num_layers):
        x, cache = body(x, enc_out, layers.layer_slice(params["dec"], j))
        for name, t in cache.items():
            caches.setdefault(name, []).append(t)
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    logits = layers.unembed(x, params["embed"])
    out = (logits,)
    if build_cache:
        out += ({k: torch.stack(v) for k, v in caches.items()},)
    if with_aux:
        out += (torch.zeros((), dtype=torch.float32, device=dev),)
    return out if len(out) > 1 else logits


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: DeviceLike = None, **_unused):
    """Empty decode cache: zero K/V, -1 positions and zero cross K/V of
    ``encoder_seq`` rows.  ``device="meta"`` gives shapes and dtypes
    without allocating."""
    dev = resolve_device(device)
    Kp, hd = cfg.replicated_kv_heads(1), cfg.head_dim
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


@torch.no_grad()
def decode_step(params, tokens, pos, cache, cfg: ModelConfig, **_unused):
    """tokens: [B, 1]; pos: [B] absolute position of the new token.
    Returns (logits [B, 1, V], new_cache).  The step writes its new slots
    into a copy of ``k``/``v``/``pos`` (the input cache is left as it
    was); ``ck``/``cv``, which no step writes, are passed on as they
    are."""
    B = tokens.shape[0]
    Hp, Kp = cfg.padded_heads(1), cfg.replicated_kv_heads(1)
    hd = cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    new_cache = {k: v if k in _READ_ONLY else v.clone()
                 for k, v in cache.items()}
    x = layers.embed_lookup(params["embed"], tokens)
    # sinusoidal at each row's decode position
    x = x + _sincos(pos.float()[:, None], cfg.d_model)[:, None].to(x.dtype)
    b_idx = torch.arange(B, device=tokens.device)
    M = new_cache["ck"].shape[2]
    cross_pos = torch.arange(M, dtype=torch.int32,
                             device=tokens.device).expand(B, M)
    cross_q = torch.full((B,), M, dtype=torch.int32, device=tokens.device)
    for j in range(cfg.num_layers):
        lp = layers.layer_slice(params["dec"], j)
        kc, vc, pc = (new_cache[n][j] for n in ("k", "v", "pos"))
        h = layers.apply_norm(x, lp["ln1"], cfg.norm)
        q = (h @ lp["attn"]["wq"]).reshape(B, 1, Hp, hd)
        k = (h @ lp["attn"]["wk"]).reshape(B, 1, Kp, hd)
        v = (h @ lp["attn"]["wv"]).reshape(B, 1, Kp, hd)
        slot = (pos % kc.shape[1]).long()
        kc[b_idx, slot] = k[:, 0]
        vc[b_idx, slot] = v[:, 0]
        pc[b_idx, slot] = pos.to(pc.dtype)
        a = layers.decode_attention(q, kc, vc, q_position=pos,
                                    k_positions=pc, scale=scale)
        x = x + a.reshape(B, 1, -1) @ lp["attn"]["wo"]
        h = layers.apply_norm(x, lp["lnx"], cfg.norm)
        qx = (h @ lp["xattn"]["wq"]).reshape(B, 1, Hp, hd)
        a = layers.decode_attention(
            qx, new_cache["ck"][j], new_cache["cv"][j], q_position=cross_q,
            k_positions=cross_pos, scale=scale)
        x = x + a.reshape(B, 1, -1) @ lp["xattn"]["wo"]
        h = layers.apply_norm(x, lp["ln2"], cfg.norm)
        x = x + layers.mlp_apply(h, lp["mlp"], gated=cfg.gated_mlp,
                                 act=cfg.act)
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    logits = layers.unembed(x, params["embed"])
    return logits, new_cache
