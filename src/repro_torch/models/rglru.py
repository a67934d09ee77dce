"""RecurrentGemma / Griffin: RG-LRU recurrent blocks and local attention,
2:1 (port of the reference package's ``models/rglru.py``).
[arXiv:2402.19427]

Layer pattern: (recurrent, recurrent, local attention) repeated; each
layer is a temporal block followed by a gated MLP.  Parameters and caches
keep the reference's nesting: ``blocks/<i>/...`` leaves carry the block
axis first (a Python loop over it replaces ``lax.scan``), ``rest/<j>/...``
hold the remainder layers unstacked (26 = 8 * 3 + 2).

``cfg.use_kernels`` sends the prefill's recurrence (``T > 1``) to the
``rglru_scan`` CUDA kernel; otherwise it runs the reference's plain
path, the log-depth ``associative_scan`` (``models/scan.py``: JAX's
recursion, bit for bit JAX's run op by op), which training, the dry-run
and the CPU run.  A decode step is one elementwise step.  The
local-attention layers use the plain ``layers.chunked_attention`` and
``layers.decode_attention``, as the reference does: it never sends them
to its attention kernels.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.interop import torch_dtype
from repro_torch.models import layers, transformer
from repro_torch.models.partition import (AxisInfo, P, dp_axes, gather_fsdp,
                                          heads_spec, local_region, mp_axis,
                                          mp_size, reshard, rows, shard,
                                          vocab_table)
from repro_torch.models.scan import associative_scan

C_SCALE = 8.0  # Griffin's fixed recurrence sharpness


def layer_types(cfg: ModelConfig) -> List[str]:
    p = cfg.attn_layer_period
    return ["attn" if (i % p) == p - 1 else "rec"
            for i in range(cfg.num_layers)]


def layout(cfg: ModelConfig) -> Tuple[List[str], int, List[str]]:
    """(block pattern, n_blocks, remainder types)."""
    types = layer_types(cfg)
    p = cfg.attn_layer_period
    n_blocks = cfg.num_layers // p
    return types[:p], n_blocks, types[n_blocks * p:]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, *, ax: Optional[AxisInfo] = None,
                **_unused) -> Dict[str, Any]:
    """Random weights with the reference's shapes, types and scales
    (``rglru.py:init_params``): matrices normal(0, 1/sqrt(fan_in)) in
    ``cfg.dtype``, f32 ``lam`` so that ``a = sigmoid(lam)^c`` starts in
    (0.9, 0.999), f32 gate weights at zero, zero rmsnorm scales.  Draws
    come from ``generator`` (seed 0 when None), not ``jax.random``.
    Under a mesh the attention heads are padded and replicated to its
    model axis; ``device="meta"`` gives shapes alone."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = torch_dtype(cfg.dtype)
    f32 = torch.float32
    D, Fd, R, cw = cfg.d_model, cfg.d_ff, cfg.rnn_dim, cfg.conv_width
    mp = mp_size(ax)
    hd = cfg.head_dim
    Hp, Kp = cfg.padded_heads(mp), cfg.replicated_kv_heads(mp)
    pattern, n_blocks, rest = layout(cfg)

    def dense(shape, fan_in):
        return layers.dense_init(shape, dtype, fan_in=fan_in,
                                 generator=generator, device=dev)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def layer(kind: str, lead: Tuple[int, ...]):
        p: Dict[str, Any] = {
            "ln1": {"scale": zeros(lead + (D,))},
            "ln2": {"scale": zeros(lead + (D,))},
            "mlp": {"w_gate": dense(lead + (D, Fd), D),
                    "w_up": dense(lead + (D, Fd), D),
                    "w_down": dense(lead + (Fd, D), Fd)},
        }
        if kind == "rec":
            u = (torch.empty(lead + (R,), dtype=f32, device=dev)
                 if dev.type == "meta" else
                 torch.rand(lead + (R,), generator=generator, dtype=f32,
                            device=dev) * (0.999 - 0.9) + 0.9)
            uc = u ** (1.0 / C_SCALE)
            p["rec"] = {
                "wx": dense(lead + (D, R), D),
                "wgate": dense(lead + (D, R), D),
                "conv_w": dense(lead + (cw, R), cw),
                "conv_b": zeros(lead + (R,)),
                "lam": torch.log(uc / (1 - uc)),
                "wi_a": zeros(lead + (R,), f32),
                "wi_b": zeros(lead + (R,), f32),
                "wr_a": zeros(lead + (R,), f32),
                "wr_b": zeros(lead + (R,), f32),
                "wo": dense(lead + (R, D), R),
            }
        else:
            p["attn"] = {"wq": dense(lead + (D, Hp * hd), D),
                         "wk": dense(lead + (D, Kp * hd), D),
                         "wv": dense(lead + (D, Kp * hd), D),
                         "wo": dense(lead + (Hp * hd, D), Hp * hd)}
        return p

    return {
        "embed": dense((cfg.padded_vocab, D), D),
        "final_norm": {"scale": zeros((D,))},
        "blocks": {str(i): layer(kind, (n_blocks,))
                   for i, kind in enumerate(pattern)},
        "rest": {str(j): layer(kind, ()) for j, kind in enumerate(rest)},
    }


# ---------------------------------------------------------------------------
# temporal blocks
# ---------------------------------------------------------------------------
def _conv1d(u, w, b, conv_state=None):
    """Causal depthwise temporal conv.  u: [B, T, R]; w: [cw, R].
    conv_state: [B, cw-1, R] previous inputs (decode)."""
    cw = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((u.shape[0], cw - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = conv_state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)                   # [B, T+cw-1, R]
    out = sum(full[:, i:i + u.shape[1]] * w[i] for i in range(cw))
    new_state = full[:, -(cw - 1):]
    return out + b, new_state


def _rglru_gates(u, rp):
    """u: [..., R] conv output -> (a, gated_input) in f32."""
    uf = u.float()
    i_gate = torch.sigmoid(rp["wi_a"] * uf + rp["wi_b"])
    r_gate = torch.sigmoid(rp["wr_a"] * uf + rp["wr_b"])
    log_a = -C_SCALE * F.softplus(rp["lam"]) * r_gate
    a = torch.exp(log_a)
    x_in = torch.sqrt(torch.clamp_min(1.0 - torch.square(a), 1e-12)) * (
        i_gate * uf)
    return a, x_in


def _gelu(x):
    return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default


def _combine(c1, c2):
    """The recurrence's pairs ``(a, h)``, ``c1`` before ``c2``."""
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def _rec_core(u, gate, conv_w, conv_b, *gates, cfg: ModelConfig,
              dtype, conv_state=None, h0=None):
    """Conv, gates and the linear recurrence ``h_t = a_t h_{t-1} + x_t``
    on one rank's channels (plain tensors: the kernel's ``ctypes``
    launch takes nothing else).  ``conv_state``/``h0`` carry a decode
    step's state.  Returns ((h * gate) in ``dtype``, h_last, conv)."""
    rp = dict(zip(("lam", "wi_a", "wi_b", "wr_a", "wr_b"), gates))
    u, conv = _conv1d(u, conv_w, conv_b, conv_state)
    a, x_in = _rglru_gates(u, rp)
    if h0 is not None:
        h = (a[:, 0] * h0 + x_in[:, 0])[:, None]
    elif cfg.use_kernels and u.shape[1] > 1:
        from repro_torch.kernels import ops as kops
        h = kops.rglru_scan(a, x_in)
    else:
        _, h = associative_scan(_combine, (a, x_in), dim=1)
    return (h * gate).to(dtype), h[:, -1], conv


_GATES = ("lam", "wi_a", "wi_b", "wr_a", "wr_b")


def _rec_block(x, rp, cfg: ModelConfig, ax, state=None):
    """x: [B, T, D] -> (out, {h, conv}); ``state`` ({h, conv}) makes it
    one decode step."""
    dm, mp = dp_axes(ax), mp_axis(ax)
    x = reshard(ax, x, dm, None, None)
    gate = _gelu((x @ rp["wgate"]).float())
    u = x @ rp["wx"]
    if state is None:
        u = shard(ax, u, dm, None, mp)
    ch = P(dm, None, mp)
    args = [reshard(ax, u, *ch), reshard(ax, gate, *ch),
            reshard(ax, rp["conv_w"], None, mp),
            *(reshard(ax, rp[n], mp) for n in ("conv_b",) + _GATES)]
    specs = [ch, ch, P(None, mp)] + [P(mp)] * 6
    core = functools.partial(_rec_core, cfg=cfg, dtype=x.dtype)
    if state is not None:
        def core(*a, _core=core):
            *a, conv, h0 = a
            return _core(*a, conv_state=conv, h0=h0)
        args += [state["conv"], state["h"]]
        specs += [P(dm, None, mp), P(dm, mp)]
    yh, h, conv = local_region(ax, core, specs,
                               (ch, P(dm, mp), P(dm, None, mp)))(*args)
    return yh @ rp["wo"], {"h": h, "conv": conv}


def _local_attn_core(q, k, v, positions, *, cfg: ModelConfig):
    """RoPE and the local (windowed) attention on one rank's heads;
    plain, as in the reference.  Returns (out, k)."""
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    chunk = min(1024, q.shape[1])
    out = layers.chunked_attention(
        q, k, v, q_positions=positions, k_positions=positions, causal=True,
        window=cfg.sliding_window, chunk_q=chunk, chunk_k=chunk,
        scale=1.0 / math.sqrt(cfg.head_dim))
    return out, k



def _attn_full(x, apm, cfg: ModelConfig, ax, positions):
    B, S, _ = x.shape
    q, k, v = transformer.project_qkv(
        reshard(ax, x, dp_axes(ax), None, None), apm, cfg, mp_size(ax))
    hs = heads_spec(ax)
    q, k, v = (reshard(ax, t, *hs) for t in (q, k, v))
    core = functools.partial(_local_attn_core, cfg=cfg)
    out, k = local_region(ax, core, (hs, hs, hs, None), (hs, hs))(
        q, k, v, positions)
    return out.reshape(B, S, -1) @ apm["wo"], k, v


def _attn_step_core(q, k, v, pos, kc, vc, pc, *, cfg: ModelConfig):
    """RoPE, the ring write at slot ``pos % W`` (IN PLACE) and the
    attention of one decode step, on one rank's rows and heads."""
    B = q.shape[0]
    q = layers.apply_rope(q, pos[:, None], cfg.rope_theta)
    k = layers.apply_rope(k, pos[:, None], cfg.rope_theta)
    W = kc.shape[1]
    slot = (pos % W).long()
    b_idx = torch.arange(B, device=q.device)
    kc[b_idx, slot] = k[:, 0]
    vc[b_idx, slot] = v[:, 0]
    pc[b_idx, slot] = pos.to(pc.dtype)
    out = layers.decode_attention(q, kc, vc, q_position=pos, k_positions=pc,
                                  window=cfg.sliding_window,
                                  scale=1.0 / math.sqrt(cfg.head_dim))
    return (out,)


def _attn_step(x, apm, cfg: ModelConfig, ax, pos, kc, vc, pc):
    """One-token local attention.  kc/vc: [B,W,Kp,hd] and pc: [B,W] —
    this layer's slices of the decode step's private cache copy, written
    IN PLACE at slot ``pos % W``."""
    B = x.shape[0]
    q, k, v = transformer.project_qkv(x, apm, cfg, mp_size(ax))
    hs, dp = heads_spec(ax), dp_axes(ax)
    q, k, v = (reshard(ax, t, *hs) for t in (q, k, v))
    core = functools.partial(_attn_step_core, cfg=cfg)
    (out,) = local_region(ax, core, (hs, hs, hs, P(dp), hs, hs, P(dp, None)),
                          (hs,))(q, k, v, reshard(ax, pos, dp), kc, vc, pc)
    return out.reshape(B, 1, -1) @ apm["wo"]


def _mlp(x, mp, ax=None):
    x = reshard(ax, x, dp_axes(ax), None, None)
    h = _gelu((x @ mp["w_gate"]).float()).to(x.dtype) * (x @ mp["w_up"])
    return h @ mp["w_down"]


# ---------------------------------------------------------------------------
def _ring_core(k, v, positions, *, cfg: ModelConfig, cache_len):
    """The prefill's local-attention cache on one rank's rows and heads:
    the last ``keep`` keys scattered to ``slot = position % W`` so
    decode's ring addressing overwrites the genuinely oldest entries
    (empty slots hold -1)."""
    B, S = k.shape[0], k.shape[1]
    cap = cache_len if cache_len else S
    W = min(cfg.sliding_window, cap) if cfg.sliding_window else cap
    keep = min(W, S)
    kept_pos = positions[S - keep:]
    slots = (kept_pos % W).long()
    ks = torch.zeros((B, W) + k.shape[2:], dtype=k.dtype, device=k.device)
    vs = torch.zeros((B, W) + v.shape[2:], dtype=v.dtype, device=v.device)
    ks[:, slots] = k[:, S - keep:]
    vs[:, slots] = v[:, S - keep:]
    ps = torch.full((B, W), -1, dtype=torch.int32, device=k.device)
    ps[:, slots] = kept_pos.to(torch.int32)
    return ks, vs, ps


def _ring_cache(k, v, positions, cfg: ModelConfig, cache_len, ax=None):
    hs = heads_spec(ax)
    core = functools.partial(_ring_core, cfg=cfg, cache_len=cache_len)
    ks, vs, ps = local_region(ax, core, (hs, hs, None),
                              (hs, hs, P(dp_axes(ax), None)))(
        k, v, positions)
    return {"k": ks, "v": vs, "pos": ps}


def _apply_layer_full(x, lp, kind: str, cfg, positions, build_cache,
                      cache_len=None, ax=None):
    lp = gather_fsdp(ax, lp)
    h = layers.apply_norm(x, lp["ln1"], cfg.norm)
    cache = {}
    if kind == "rec":
        y, cache = _rec_block(h, lp["rec"], cfg, ax)
        if not build_cache:
            cache = {}
    else:
        y, k, v = _attn_full(h, lp["attn"], cfg, ax, positions)
        if build_cache:
            cache = _ring_cache(k, v, positions, cfg, cache_len, ax)
    x = x + rows(ax, y)
    h = layers.apply_norm(x, lp["ln2"], cfg.norm)
    return x + rows(ax, _mlp(h, lp["mlp"], ax)), cache


def _apply_layer_step(x, lp, kind: str, cfg, pos, cache, ax=None):
    """``cache`` holds views of the step's private copy: a recurrent
    layer's new state and an attention layer's new slot are written into
    them."""
    lp = gather_fsdp(ax, lp)
    h = layers.apply_norm(x, lp["ln1"], cfg.norm)
    if kind == "rec":
        y, new = _rec_block(h, lp["rec"], cfg, ax, state=cache)
        cache["h"].copy_(new["h"])
        cache["conv"].copy_(new["conv"].to(cache["conv"].dtype))
    else:
        y = _attn_step(h, lp["attn"], cfg, ax, pos, cache["k"], cache["v"],
                       cache["pos"])
    x = x + y
    h = layers.apply_norm(x, lp["ln2"], cfg.norm)
    return x + _mlp(h, lp["mlp"], ax)


def forward(params, tokens, cfg: ModelConfig, *,
            ax: Optional[AxisInfo] = None, build_cache: bool = False,
            cache_len: Optional[int] = None, remat: bool = False,
            with_aux: bool = False, **_unused):
    """tokens: [B, S] -> logits [B, S, V]; with ``build_cache`` also the
    decode cache ``{"blocks": {...}, "rest": {...}}``, and with
    ``with_aux`` a zero f32 aux loss (the family has no router).
    ``remat`` checkpoints each block of the pattern (the reference's
    plain ``jax.checkpoint``; the remainder layers are not).
    Differentiable: the caller picks grad mode."""
    pattern, n_blocks, rest = layout(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    dp, mp = dp_axes(ax), mp_axis(ax)
    table = vocab_table(params, ax)
    x = layers.embed_lookup(table, tokens, scale_by_dim=cfg.embedding_scale)
    x = shard(ax, x, dp, mp, None)

    def block_fn(x, bp):
        x = shard(ax, x, dp, mp, None)
        caches = {}
        for i, kind in enumerate(pattern):
            x, caches[str(i)] = _apply_layer_full(
                x, bp[str(i)], kind, cfg, positions, build_cache, cache_len,
                ax)
        return x, caches

    body = layers.remat_block(block_fn) if remat else block_fn
    block_caches: Dict[str, Dict[str, list]] = {
        str(i): {} for i in range(len(pattern))}
    for j in range(n_blocks):
        x, c = body(x, layers.layer_slice(params["blocks"], j))
        for i, leaves in c.items():
            for name, leaf in leaves.items():
                block_caches[i].setdefault(name, []).append(leaf)
    rest_caches = {}
    for j, kind in enumerate(rest):
        x, c = _apply_layer_full(x, params["rest"][str(j)], kind, cfg,
                                 positions, build_cache, cache_len, ax)
        rest_caches[str(j)] = c
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    logits = layers.unembed(rows(ax, x), table,
                            softcap=cfg.final_logit_softcap)
    logits = shard(ax, logits, dp, mp, None)
    out = (logits,)
    if build_cache:
        blocks = {i: {n: torch.stack(v) for n, v in c.items()}
                  for i, c in block_caches.items()}
        out += ({"blocks": blocks, "rest": rest_caches},)
    if with_aux:
        out += (x.new_zeros((), dtype=torch.float32),)
    return out if len(out) > 1 else logits


def _empty_layer_cache(cfg: ModelConfig, kind: str, batch: int,
                       cache_len: int, lead: Tuple[int, ...], dev, mp=1):
    dtype = torch_dtype(cfg.dtype)
    if kind == "rec":
        R, cw = cfg.rnn_dim, cfg.conv_width
        return {"h": torch.zeros(lead + (batch, R), dtype=torch.float32,
                                 device=dev),
                "conv": torch.zeros(lead + (batch, cw - 1, R), dtype=dtype,
                                    device=dev)}
    Kp, hd = cfg.replicated_kv_heads(mp), cfg.head_dim
    W = min(cfg.sliding_window, cache_len) if cfg.sliding_window \
        else cache_len
    return {"k": torch.zeros(lead + (batch, W, Kp, hd), dtype=dtype,
                             device=dev),
            "v": torch.zeros(lead + (batch, W, Kp, hd), dtype=dtype,
                             device=dev),
            "pos": torch.full(lead + (batch, W), -1, dtype=torch.int32,
                              device=dev)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: DeviceLike = None, *, ax: Optional[AxisInfo] = None,
               **_unused):
    """Empty decode cache.  ``device="meta"`` gives shapes and dtypes
    without allocating."""
    dev = resolve_device(device)
    pattern, n_blocks, rest = layout(cfg)
    mp = mp_size(ax)
    return {
        "blocks": {str(i): _empty_layer_cache(cfg, kind, batch, cache_len,
                                              (n_blocks,), dev, mp)
                   for i, kind in enumerate(pattern)},
        "rest": {str(j): _empty_layer_cache(cfg, kind, batch, cache_len, (),
                                            dev, mp)
                 for j, kind in enumerate(rest)},
    }


def cache_pspecs(cfg: ModelConfig, ax: AxisInfo, **_unused):
    """Partition specs matching :func:`init_cache`: batch over data,
    channels and KV heads over model."""
    pattern, _, rest = layout(cfg)
    dp, mp = ax.batch, ax.model

    def spec(kind, lead):
        if kind == "rec":
            return {"h": P(*lead, dp, mp),
                    "conv": P(*lead, dp, None, mp)}
        return {"k": P(*lead, dp, None, mp, None),
                "v": P(*lead, dp, None, mp, None),
                "pos": P(*lead, dp, None)}

    return {
        "blocks": {str(i): spec(kind, (None,))
                   for i, kind in enumerate(pattern)},
        "rest": {str(j): spec(kind, ()) for j, kind in enumerate(rest)},
    }


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


@torch.no_grad()
def decode_step(params, tokens, pos, cache, cfg: ModelConfig, *,
                ax: Optional[AxisInfo] = None, **_unused):
    """tokens: [B, 1]; pos: [B].  Returns (logits [B, 1, V], new cache).
    The input cache is left as it was: the step writes into a copy (the
    reference's ``.at[].set`` is functional, and the cache tensors may be
    views of table columns that other consumers share)."""
    pattern, n_blocks, rest = layout(cfg)
    new_cache = _clone(cache)
    table = vocab_table(params, ax)
    x = layers.embed_lookup(table, tokens, scale_by_dim=cfg.embedding_scale)
    x = shard(ax, x, dp_axes(ax), None, None)
    for j in range(n_blocks):
        bp = layers.layer_slice(params["blocks"], j)
        bc = layers.layer_slice(new_cache["blocks"], j)   # views of the copy
        for i, kind in enumerate(pattern):
            x = _apply_layer_step(x, bp[str(i)], kind, cfg, pos, bc[str(i)],
                                  ax)
    for j, kind in enumerate(rest):
        x = _apply_layer_step(x, params["rest"][str(j)], kind, cfg, pos,
                              new_cache["rest"][str(j)], ax)
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    logits = layers.unembed(rows(ax, x), table,
                            softcap=cfg.final_logit_softcap)
    return logits, new_cache
