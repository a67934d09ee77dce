"""RWKV-6 "Finch": attention-free time mix with data-dependent decay
(port of the reference package's ``models/rwkv6.py``).  [arXiv:2404.05892]

State per layer: the wkv matrix state S [B, H, hd, hd] (f32) and the two
token-shift vectors.  Parameters keep the reference's layer-stacked
layout (``blocks/...`` leaves carry the layer axis first); a Python loop
over that axis replaces ``lax.scan``.

Types follow JAX's promotion: the mixing vectors, ``u``, ``w0`` and the
group-norm params are f32 and the matrices are in ``cfg.dtype``, so the
mixed inputs are f32 and their products with bf16 weights run in f32
(``torch.matmul`` refuses mixed types; :func:`_mm` casts the weight).

``cfg.use_kernels`` sends the prefill's recurrence (``T > 1``) to the
``wkv6`` CUDA kernel, which also returns the final state for the decode
cache; otherwise it runs :func:`wkv_chunked`, the recurrence in chunks
of 16 steps joined by a log-depth scan, which training, the dry-run and
the CPU run (the reference compiles one ``lax.scan`` there).  A decode
step is one elementwise step in plain PyTorch, as in the reference.  On
CPU tensors the kernel wrapper runs its plain version.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.interop import torch_dtype
from repro_torch.models import layers
from repro_torch.models.partition import (AxisInfo, P, dp_axes, gather_fsdp,
                                          local_region, mp_axis, reshard, rows,
                                          shard, vocab_table)
from repro_torch.models.scan import associative_scan

TM_LORA = 32
DECAY_LORA = 64


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, **_unused) -> Dict[str, Any]:
    """Random weights with the reference's shapes, types and scales
    (``rwkv6.py:init_params``): f32 mixing vectors uniform in +-0.1, ``u``
    in +-0.5, ``w0`` = -0.5, unit group norm; matrices normal(0,
    1/sqrt(fan_in)) in ``cfg.dtype``.  Draws come from ``generator``
    (seed 0 when None), not the reference's ``jax.random``.  The mesh's
    model axis changes no shape (the heads are never padded);
    ``device="meta"`` gives shapes alone."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = torch_dtype(cfg.dtype)
    D, Fd, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    H, hd = cfg.num_rwkv_heads, cfg.rwkv_head_dim
    f32 = torch.float32

    def dense(shape, fan_in):
        return layers.dense_init(shape, dtype, fan_in=fan_in,
                                 generator=generator, device=dev)

    def uniform(shape, s=0.1):
        if dev.type == "meta":
            return torch.empty(shape, dtype=f32, device=dev)
        x = torch.rand(shape, generator=generator, dtype=f32, device=dev)
        return x.mul_(2 * s).sub_(s)

    def norms():
        return {"scale": torch.ones((L, D), dtype=dtype, device=dev),
                "bias": torch.zeros((L, D), dtype=dtype, device=dev)}

    blocks = {
        "ln1": norms(),
        "ln2": norms(),
        "mu_x": uniform((L, D)),
        "mu_mix": uniform((L, 5, D)),
        "tm_w1": dense((L, D, 5 * TM_LORA), D),
        "tm_w2": dense((L, 5, TM_LORA, D), TM_LORA),
        "w0": torch.full((L, D), -0.5, dtype=f32, device=dev),
        "dw1": dense((L, D, DECAY_LORA), D),
        "dw2": dense((L, DECAY_LORA, D), DECAY_LORA),
        "u": uniform((L, H, hd), 0.5),
        "wr": dense((L, D, D), D),
        "wk": dense((L, D, D), D),
        "wv": dense((L, D, D), D),
        "wg": dense((L, D, D), D),
        "wo": dense((L, D, D), D),
        "gn_scale": torch.ones((L, D), dtype=f32, device=dev),
        "gn_bias": torch.zeros((L, D), dtype=f32, device=dev),
        "cm_mu_k": uniform((L, D)),
        "cm_mu_r": uniform((L, D)),
        "cm_wk": dense((L, D, Fd), D),
        "cm_wv": dense((L, Fd, D), Fd),
        "cm_wr": dense((L, D, D), D),
    }
    return {
        "embed": dense((cfg.padded_vocab, D), D),
        "final_norm": {"scale": torch.ones((D,), dtype=dtype, device=dev),
                       "bias": torch.zeros((D,), dtype=dtype, device=dev)},
        "blocks": blocks,
    }


def _mm(a, b):
    """``a @ b`` in the promoted type, as JAX computes a mixed product."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _lora_mix(xxx, w1, w2):
    """The 5 low-rank mixing offsets [B, T, 5, D] of ``_ddlerp``."""
    B, T, _ = xxx.shape
    low = torch.tanh(_mm(xxx, w1)).reshape(B, T, 5, TM_LORA)
    return (torch.einsum("btjl,jld->btjd", low,
                         w2.to(torch.promote_types(low.dtype, w2.dtype))),)


def _ddlerp(x, xprev, lp, ax=None):
    """Data-dependent lerp producing the 5 mixed inputs (w,k,v,r,g).  The
    low-rank products run on each rank's channels (``local_region``):
    DTensor's rules left their gradients split over both the batch and
    the sequence in one folded dim, which no product rule takes."""
    dx = xprev - x
    xxx = x + dx * lp["mu_x"]
    dm, mp = dp_axes(ax), mp_axis(ax)
    (mixes,) = local_region(
        ax, _lora_mix, (P(dm, None, None), P(None, None), P(None, None, mp)),
        (P(dm, None, None, mp),), grad_specs=("partial",) * 3)(
        reshard(ax, xxx, dm, None, None), reshard(ax, lp["tm_w1"], None, None),
        reshard(ax, lp["tm_w2"], None, None, mp))
    return [x + dx * (lp["mu_mix"][j] + mixes[:, :, j]) for j in range(5)]


def _exclusive(p, dim):
    """``p`` shifted one step along ``dim`` with a leading 1: the exclusive
    form of an inclusive ``cumprod``."""
    ones = torch.ones_like(p.narrow(dim, 0, 1))
    return torch.cat([ones, p.narrow(dim, 0, p.shape[dim] - 1)], dim=dim)


def _combine_states(c1, c2):
    """Chunk (decay, state) pairs, ``c1`` before ``c2``."""
    a1, s1 = c1
    a2, s2 = c2
    return a1 * a2, a2[..., None] * s1 + s2


def wkv_chunked(r, k, v, w, u, state=None, chunk: int = 16):
    """WKV6 in chunks of ``chunk`` steps, all chunks at once, with the
    contract of the sequential ``ref.wkv6_state_ref``: r, k, v, w
    [B, T, H, hd], u [H, hd], state [B, H, hd, hd] or None (zeros).
    Returns (y [B, T, H, hd], final state), both f32.

    Within a chunk, step t reads step s < t through the decay of the steps
    between them, ``prod_{s<j<t} w_j``: a product over a mask for each
    (t, s) pair, never a ratio of prefix products, so decays near 0 lose
    no digits and a w of exactly 0 gives exact zeros and finite gradients.
    Each chunk's own state and total decay then pass from chunk to chunk
    through :func:`associative_scan`, seeded with ``state``, and each step
    reads its chunk's start state through the decay since the chunk's
    start.  T is padded to a multiple of ``chunk`` with w = 1 and zero
    r, k, v, steps that leave the state as it was.  Torch ops only (no
    value read), so the traced op count grows as O(log T)."""
    B, T, H, hd = r.shape
    C = chunk
    N = -(-T // C)
    f32 = torch.float32
    r, k, v, w = (t.to(f32) for t in (r, k, v, w))
    pad = N * C - T
    if pad:
        def padded(t, value):
            return F.pad(t, (0, 0, 0, 0, 0, pad), value=value)
        r, k, v = (padded(t, 0.0) for t in (r, k, v))
        w = padded(w, 1.0)
    r, k, v, w = (t.reshape(B, N, C, H, hd) for t in (r, k, v, w))
    # prod_{s<j<t} w_j for every (t, s): row t keeps w_j for j < t, 1 after
    idx = torch.arange(C, device=r.device)
    before = (idx[None, :] < idx[:, None])[None, None, :, :, None, None]
    rows = torch.where(before, w[:, :, None], 1.0)           # [B,N,t,j,H,hd]
    between = _exclusive(rows.flip(3).cumprod(3), 3).flip(3)  # [B,N,t,s,H,hd]
    att = torch.einsum("bnthi,bntshi,bnshi->bntsh", r, between, k)
    att = att * before[..., 0]                               # s < t only
    bonus = (r * u.to(f32) * k).sum(-1)                      # [B,N,t,H]
    y = torch.einsum("bntsh,bnshj->bnthj", att, v) + bonus[..., None] * v
    # each chunk's own state and its total decay
    after = _exclusive(w.flip(2).cumprod(2), 2).flip(2)      # prod_{j>s}
    own = torch.einsum("bnshi,bnshj->bnhij", after * k, v)
    since = w.cumprod(2)                                     # prod_{j<=t}
    total = since[:, :, -1]                                  # [B,N,H,hd]
    S0 = (r.new_zeros((B, 1, H, hd, hd)) if state is None
          else state.to(f32)[:, None])
    _, ends = associative_scan(
        _combine_states,
        (torch.cat([torch.ones_like(total[:, :1]), total], dim=1),
         torch.cat([S0, own], dim=1)), dim=1)
    starts = ends[:, :N]                                     # [B,N,H,i,j]
    y = y + torch.einsum("bnthi,bnhij->bnthj", r * _exclusive(since, 2),
                         starts)
    return y.reshape(B, N * C, H, hd)[:, :T], ends[:, N]


def _wkv_step(r, k, v, w, u, S):
    """One decode step of the recurrence (r, k, v, w [B, 1, H, hd])."""
    kv = k[:, 0, :, :, None] * v[:, 0, :, None, :]           # [B,H,i,j]
    y = torch.einsum("bhi,bhij->bhj", r[:, 0], S + u[None, :, :, None] * kv)
    return y[:, None], w[:, 0, :, :, None] * S + kv


def _wkv_core(r4, k4, v4, w4, u, S, *, cfg: ModelConfig, need_state: bool):
    """The recurrence on one rank's heads (plain tensors: the kernel's
    ``ctypes`` launch takes nothing else).  Returns (y, S)."""
    if r4.shape[1] == 1:
        return _wkv_step(r4, k4, v4, w4, u, S)
    if cfg.use_kernels:
        from repro_torch.kernels import ops as kops
        # the kernel covers the zero-state fresh sequence (prefill) and
        # returns the tail state for the decode cache in the same pass
        if need_state:
            return kops.wkv6(r4, k4, v4, w4, u, return_state=True)
        return kops.wkv6(r4, k4, v4, w4, u), S
    return wkv_chunked(r4, k4, v4, w4, u, S)


def _decay(xw, dw1, dw2, w0):
    """The data-dependent decay ``exp(-exp(w0 + tanh(xw dw1) dw2))``, f32."""
    decay_low = _mm(torch.tanh(_mm(xw, dw1)), dw2)
    return (torch.exp(-torch.exp((w0 + decay_low).to(torch.float32))),)


def _time_mix(x, xprev, S, lp, cfg: ModelConfig, ax=None, *,
              need_state=True):
    B, T, D = x.shape
    H, hd = cfg.num_rwkv_heads, cfg.rwkv_head_dim
    dm, mp = dp_axes(ax), mp_axis(ax)
    # whole rows on every model rank ahead of the products
    x, xprev = (reshard(ax, t, dm, None, None) for t in (x, xprev))
    xw, xk, xv, xr, xg = (rows(ax, t) for t in _ddlerp(x, xprev, lp, ax))
    f32 = torch.float32
    r = _mm(xr, lp["wr"]).to(f32)
    k = _mm(xk, lp["wk"]).to(f32)
    v = _mm(xv, lp["wv"]).to(f32)
    g = F.silu(_mm(xg, lp["wg"]).to(f32))
    r = shard(ax, r, dm, None, mp)
    k = shard(ax, k, dm, None, mp)
    v = shard(ax, v, dm, None, mp)
    # the decay's low-rank products on each rank's channels, as in
    # ``_ddlerp``
    chans = P(dm, None, mp)
    (w,) = local_region(ax, _decay, (P(dm, None, None), P(None, None),
                                     P(None, mp), P(mp)), (chans,),
                        grad_specs=("partial",) * 4)(
        xw, reshard(ax, lp["dw1"], None, None),
        reshard(ax, lp["dw2"], None, mp), reshard(ax, lp["w0"], mp))
    w = shard(ax, w, dm, None, mp)                              # [B,T,D]
    hshape = (B, T, H, hd)
    heads, state = P(dm, None, mp, None), P(dm, mp, None, None)
    core = functools.partial(_wkv_core, cfg=cfg, need_state=need_state)
    y, S = local_region(ax, core, (heads,) * 4 + (P(mp, None), state),
                        (heads, state))(
        *(t.reshape(hshape) for t in (r, k, v, w)),
        reshard(ax, lp["u"].to(f32), mp, None), reshard(ax, S, *state))
    y = layers.groupnorm_heads(y.reshape(B, T, D), lp["gn_scale"],
                               lp["gn_bias"], H)
    out = (y * g).to(x.dtype) @ lp["wo"]
    return out, S


def _channel_mix(x, xprev, lp, ax=None):
    x, xprev = (reshard(ax, t, dp_axes(ax), None, None) for t in (x, xprev))
    dx = xprev - x
    xk = x + dx * lp["cm_mu_k"]
    xr = x + dx * lp["cm_mu_r"]
    kk = torch.square(torch.relu(_mm(xk, lp["cm_wk"])))
    return torch.sigmoid(_mm(xr, lp["cm_wr"])) * _mm(kk, lp["cm_wv"])


def _shift(x, prev):
    """prev: [B, D] last token of the previous chunk (zeros at t=0)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def forward(params, tokens, cfg: ModelConfig, *,
            ax: Optional[AxisInfo] = None, build_cache: bool = False,
            cache_len: Optional[int] = None, remat: bool = False,
            with_aux: bool = False, **_unused):
    """tokens: [B, T] -> logits [B, T, V]; with ``build_cache`` also the
    decode cache {S, tm_shift, cm_shift} stacked over layers, and with
    ``with_aux`` a zero f32 aux loss (the family has no router).
    ``remat`` checkpoints each layer (the reference's plain
    ``jax.checkpoint``).  Under a mesh (``ax``) the residual stream is
    split over the sequence, as in the reference, and the recurrence
    runs on each rank's heads.  Differentiable: the caller picks grad
    mode."""
    B, T = tokens.shape
    H, hd = cfg.num_rwkv_heads, cfg.rwkv_head_dim
    dtype = torch_dtype(cfg.dtype)
    dp, mp = dp_axes(ax), mp_axis(ax)
    table = vocab_table(params, ax)
    x = layers.embed_lookup(table, tokens)
    x = shard(ax, x, dp, mp, None)

    def block_fn(x, lp):
        lp = gather_fsdp(ax, lp)
        x = shard(ax, x, dp, mp, None)
        zeros_shift = x.new_zeros((B, x.shape[-1]))
        S0 = x.new_zeros((B, H, hd, hd), dtype=torch.float32)
        h1 = layers.layernorm(x, lp["ln1"]["scale"], lp["ln1"]["bias"])
        tm_out, S = _time_mix(h1, _shift(h1, zeros_shift), S0, lp, cfg, ax,
                              need_state=build_cache)
        x = x + rows(ax, tm_out)
        h2 = layers.layernorm(x, lp["ln2"]["scale"], lp["ln2"]["bias"])
        x = (x + rows(ax, _channel_mix(h2, _shift(h2, zeros_shift), lp,
                                       ax))).to(dtype)
        cache_out = ({"S": S, "tm_shift": h1[:, -1], "cm_shift": h2[:, -1]}
                     if build_cache else {})
        return x, cache_out

    body = layers.remat_block(block_fn) if remat else block_fn
    caches: Dict[str, list] = {"S": [], "tm_shift": [], "cm_shift": []}
    for j in range(cfg.num_layers):
        x, cache_out = body(x, layers.layer_slice(params["blocks"], j))
        for name, t in cache_out.items():
            caches[name].append(t)
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    logits = layers.unembed(rows(ax, x), table)
    logits = shard(ax, logits, dp, mp, None)
    out = (logits,)
    if build_cache:
        out += ({k: torch.stack(v) for k, v in caches.items()},)
    if with_aux:
        out += (x.new_zeros((), dtype=torch.float32),)
    return out if len(out) > 1 else logits


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: DeviceLike = None, **_unused):
    """Empty decode cache (stacked over layers).  ``device="meta"`` gives
    shapes and dtypes without allocating."""
    dev = resolve_device(device)
    L = cfg.num_layers
    D, H, hd = cfg.d_model, cfg.num_rwkv_heads, cfg.rwkv_head_dim
    dtype = torch_dtype(cfg.dtype)
    return {
        "S": torch.zeros((L, batch, H, hd, hd), dtype=torch.float32,
                         device=dev),
        "tm_shift": torch.zeros((L, batch, D), dtype=dtype, device=dev),
        "cm_shift": torch.zeros((L, batch, D), dtype=dtype, device=dev),
    }


def cache_pspecs(cfg: ModelConfig, ax: AxisInfo, **_unused):
    """Partition specs matching :func:`init_cache`: batch over data, the
    state's heads over model."""
    dp, mp = ax.batch, ax.model
    return {"S": P(None, dp, mp, None, None),
            "tm_shift": P(None, dp, None),
            "cm_shift": P(None, dp, None)}


@torch.no_grad()
def decode_step(params, tokens, pos, cache, cfg: ModelConfig, *,
                ax: Optional[AxisInfo] = None, **_unused):
    """tokens: [B, 1].  Cache: {S, tm_shift, cm_shift} stacked over
    layers.  Returns (logits [B, 1, V], new cache); the input cache is
    left as it was (every layer's state is new, stacked afresh)."""
    dtype = torch_dtype(cfg.dtype)
    new: Dict[str, list] = {"S": [], "tm_shift": [], "cm_shift": []}
    table = vocab_table(params, ax)
    x = layers.embed_lookup(table, tokens)
    x = shard(ax, x, dp_axes(ax), None, None)
    for j in range(cfg.num_layers):
        lp = gather_fsdp(ax, layers.layer_slice(params["blocks"], j))
        c = {k: v[j] for k, v in cache.items()}
        h = layers.layernorm(x, lp["ln1"]["scale"], lp["ln1"]["bias"])
        tm_out, S = _time_mix(h, c["tm_shift"][:, None], c["S"], lp, cfg, ax)
        x = x + rows(ax, tm_out)
        h2 = layers.layernorm(x, lp["ln2"]["scale"], lp["ln2"]["bias"])
        x = (x + rows(ax, _channel_mix(h2, c["cm_shift"][:, None], lp,
                                       ax))).to(dtype)
        new["S"].append(S)
        new["tm_shift"].append(h[:, -1])
        new["cm_shift"].append(h2[:, -1])
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    logits = layers.unembed(rows(ax, x), table)
    return logits, {k: torch.stack(v).to(cache[k].dtype)
                    for k, v in new.items()}
