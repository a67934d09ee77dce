"""Decoder-only transformer (port of the reference package's
``models/transformer.py``: the dense family — yi, glm4, granite and
gemma2 — the moe family — arctic and llama4 — and the vlm family,
llama-3.2-vision).

Layers are grouped into the smallest repeating *block*, as in the
reference:

* dense (yi, glm4, granite):  block = [attn+mlp]                x L
* gemma2:                     block = [local, global]           x L/2
* arctic:                     block = [attn+moe(+dense res)]    x L
* llama4-maverick:            block = [attn+mlp, attn+moe]      x L/2
* llama-3.2-vision:           block = [plain x4, cross+plain]   x L/5
* deepseek-moe:               [attn+mlp] x 1, then
                              block = [attn+moe+shared]         x (L-1)

A dense prefix (``cfg.first_k_dense`` leading layers with a dense MLP,
deepseek-moe's first layer) runs before the repeated block as a group of
its own (:func:`layer_groups`): its params and cache take the first keys
(``blocks/0``, ``k0``, ...), stacked over the prefix's layers, and the
block's keys follow.

Parameters keep the reference's layer-stacked layout (``blocks/"<i>"/...``
leaves carry the block axis first), so bridged JAX params drop straight
in; a Python loop over that axis replaces ``lax.scan``.  KV caches are
stacked the same way: ``k<i>``/``v<i>`` ``[n_blocks, B, W, K, hd]`` ring
buffers and ``pos<i>`` ``[n_blocks, B, W]`` slot positions (-1 = empty);
with ``kv_quant`` the ring holds int8 values and ``ks<i>``/``vs<i>``
``[n_blocks, B, W, K]`` f32 scales; a cross layer adds the media K/V
``ck<i>``/``cv<i>`` ``[n_blocks, B, M, K, hd]``.  A MoE layer's FFN is
:func:`repro_torch.models.moe.moe_apply` (plus the dense residual or the
shared experts, ``aux_mlp``, ``cfg.aux_ff`` wide), inside a ``moe``
profiler range (``obs/trace.scope``); its caches are the dense ones.
With ``tie_embeddings`` off the output head is a ``head`` leaf
``[padded_vocab, D]`` of its own, else the embedding table.

The prefill keeps the reference's ring layout: a layer of window W < S
stores positions S-W..S-1 at slots 0..W-1, while a decode step writes
position p at slot ``p % W``.  When S > W and S % W != 0 the first decode
steps overwrite keys still inside the window; the reference does the
same, and the port keeps it for parity (ROADMAP.md §3).

The layers' ops (the two self-attention sites, the elementwise glue and
the MoE call's) come from one record a call,
:func:`repro_torch.models.layer_ops.layer_ops`, which chooses between the
CUDA kernels and their plain versions.  A residual add is held back
(``delta``) for the norm that reads its sum.
The kernels have no backward, as the reference's have none: training
differentiates the plain composition (``use_kernels=False``), and a
kernel wrapper refuses CUDA inputs that require grad.
Cross attention stays plain PyTorch, as in the reference, which calls no
Pallas kernel there.

Under a mesh (``ax``, :mod:`repro_torch.models.partition`) the heads are
padded and the KV heads replicated to the model axis, the params, inputs
and cache are DTensors, and the reference's ``shard`` sites redistribute
the residual stream; the attention cores and the ring writes run on each
rank's local heads in ``local_map`` regions, so the kernels see plain
tensors.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.interop import torch_dtype
from repro_torch.models import layer_ops, layers, moe as moe_lib
from repro_torch.models.partition import (AxisInfo, P, dp_axes, gather_fsdp,
                                          heads_spec, local_region, mp_axis,
                                          mp_size, reshard, rows, shard,
                                          vocab_table)
from repro_torch.obs.trace import scope


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    window: int = 0            # 0 = full attention
    is_moe: bool = False
    has_cross: bool = False    # gated cross-attention (vlm)
    aux_mlp: bool = False      # dense residual (arctic) / shared expert


def block_layout(cfg: ModelConfig, *, long_context: bool = False
                 ) -> Tuple[List[LayerSpec], int]:
    """Return (specs for one block, n_blocks) of the repeated block: the
    layers after the ``cfg.first_k_dense`` dense prefix, all of them
    where there is none (:func:`layer_groups` has the prefix).  A config
    of a family this module does not serve raises."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not a transformer family (dense, "
            "moe and vlm)")
    L = cfg.num_layers - cfg.first_k_dense
    if cfg.family == "vlm" and cfg.cross_attn_period:
        p = cfg.cross_attn_period
        if L % p:
            raise ValueError(f"{cfg.name}: {L} layers do not divide into "
                             f"blocks of {p}")
        return [LayerSpec() for _ in range(p - 1)] + [
            LayerSpec(has_cross=True)], L // p
    if cfg.local_global_pattern:  # gemma2: [local, global] pairs
        p = cfg.local_global_pattern
        if L % p:
            raise ValueError(f"{cfg.name}: {L} layers do not divide into "
                             f"blocks of {p}")
        w_global = cfg.sliding_window if (
            long_context and cfg.long_context_windowed) else 0
        return [LayerSpec(window=cfg.sliding_window)
                for _ in range(p - 1)] + [LayerSpec(window=w_global)], L // p
    if cfg.num_experts and cfg.moe_layer_period > 1:  # llama4
        p = cfg.moe_layer_period
        if L % p:
            raise ValueError(f"{cfg.name}: {L} layers do not divide into "
                             f"blocks of {p}")
        return [LayerSpec() for _ in range(p - 1)] + [
            LayerSpec(is_moe=True, aux_mlp=cfg.shared_expert)], L // p
    if cfg.num_experts:  # arctic, deepseek-moe
        return [LayerSpec(is_moe=True, aux_mlp=cfg.dense_residual
                          or cfg.shared_expert)], L
    return [LayerSpec()], L


#: one group of layers: (the key of its first layer, the specs of one
#: repeat, the repeats)
Group = Tuple[int, List[LayerSpec], int]


def layer_groups(cfg: ModelConfig, *, long_context: bool = False
                 ) -> List[Group]:
    """The layers in the order they run, as groups ``(first, specs, n)``:
    ``n`` repeats of ``specs``, whose layer i keeps its params under
    ``blocks/<first + i>`` and its cache leaves under ``k<first + i>``,
    ``v<first + i>``, ... (each stacked over the ``n`` repeats).  Without
    a dense prefix one group, ``(0, *block_layout(cfg))``.  With
    ``cfg.first_k_dense`` = p the p dense layers come first, ``(0,
    [LayerSpec()], p)``, and the block follows from key 1: deepseek-moe's
    ``blocks/0`` is its dense layer 0 and ``blocks/1`` its 27 MoE
    layers."""
    specs, n = block_layout(cfg, long_context=long_context)
    if not cfg.first_k_dense:
        return [(0, specs, n)]
    return [(0, [LayerSpec()], cfg.first_k_dense), (1, specs, n)]


def _block_slices(blocks, groups: List[Group]):
    """``(first, specs, j, params)`` of every block of ``groups`` in the
    order they run: ``params`` the j-th slice of the group's
    ``blocks/<first + i>`` leaves (views)."""
    for first, specs, n in groups:
        sub = blocks if len(groups) == 1 else {
            str(c): blocks[str(c)] for c in range(first, first + len(specs))}
        for j in range(n):
            yield first, specs, j, layers.layer_slice(sub, j)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, *, ax: Optional[AxisInfo] = None,
                long_context: bool = False) -> Dict[str, Any]:
    """Random weights with the reference's shapes and scales
    (``transformer.py:init_params``): normal(0, 1/sqrt(fan_in)) matrices,
    normal(0, 1/sqrt(d)) embedding, zero rmsnorm scales, zero f32 cross
    ``gate``s; a MoE layer's experts come from ``moe.moe_init`` (int8 with
    ``expert_quant``), in place of the dense MLP.  The draws come from
    ``generator`` (seed 0 when None) on ``device``; they are not the
    reference's ``jax.random`` draws — bridge those with
    :func:`repro_torch.interop.params_from_numpy`.  Under a mesh of model
    axis ``mp`` the Q heads are padded and the KV heads replicated to a
    multiple of ``mp`` (``cfg.padded_heads``/``replicated_kv_heads``), as
    in the reference; ``device="meta"`` gives shapes alone."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = torch_dtype(cfg.dtype)
    D, hd = cfg.d_model, cfg.head_dim
    mp = mp_size(ax)
    Hp, Kp = cfg.padded_heads(mp), cfg.replicated_kv_heads(mp)

    def dense(shape, fan_in):
        return layers.dense_init(shape, dtype, fan_in=fan_in,
                                 generator=generator, device=dev)

    def norm(lead):
        return layers.init_norm(D, cfg.norm, dtype, dev, lead=lead)

    params: Dict[str, Any] = {
        "embed": dense((cfg.padded_vocab, D), D),
        "final_norm": norm(()),
        "blocks": {},
    }

    def mlp(n, F):
        p = {"w_up": dense((n, D, F), D), "w_down": dense((n, F, D), F)}
        if cfg.gated_mlp:
            p["w_gate"] = dense((n, D, F), D)
        return p

    for first, specs, n in layer_groups(cfg, long_context=long_context):
        for i, spec in enumerate(specs):
            ffn: Dict[str, Any] = {}
            if spec.is_moe:
                m = moe_lib.moe_init(cfg, dtype, n, generator=generator,
                                     device=dev)
                if cfg.expert_quant:
                    # one matrix at a time, so the stack it replaces is
                    # freed
                    for name in [k for k in m if k != "router"]:
                        m[name] = moe_lib.quantize_expert_weights(
                            {name: m[name]})[name]
                ffn["moe"] = m
                if spec.aux_mlp:
                    ffn["aux_mlp"] = mlp(n, cfg.aux_ff)
            else:
                ffn["mlp"] = mlp(n, cfg.d_ff)
            lp: Dict[str, Any] = {
                "ln1": norm((n,)),
                "attn": {"wq": dense((n, D, Hp * hd), D),
                         "wk": dense((n, D, Kp * hd), D),
                         "wv": dense((n, D, Kp * hd), D),
                         "wo": dense((n, Hp * hd, D), Hp * hd)},
                "ln2": norm((n,)),
                **ffn,
            }
            if cfg.post_norms:
                lp["post_ln1"] = norm((n,))
                lp["post_ln2"] = norm((n,))
            if spec.has_cross:
                lp["cross"] = {
                    "ln": norm((n,)),
                    "wq": dense((n, D, Hp * hd), D),
                    "wk": dense((n, D, Kp * hd), D),
                    "wv": dense((n, D, Kp * hd), D),
                    "wo": dense((n, Hp * hd, D), Hp * hd),
                    "gate": torch.zeros((n,), dtype=torch.float32,
                                        device=dev),
                }
            params["blocks"][str(first + i)] = lp
    if not cfg.tie_embeddings:
        params["head"] = dense((cfg.padded_vocab, D), D)
    return params


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------
def _attn_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.head_dim)


#: (head_dim, theta, device) -> the RoPE frequency table, built once
_ROPE_TABLES: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def rope_table(head_dim: int, theta: float, device) -> Optional[torch.Tensor]:
    """``layers.rope_frequencies(head_dim, theta)`` on ``device``, the
    table every RoPE of the layers reads, built once and kept; None where
    theta <= 0 (no rotation).  A table built on fake tensors (a shape
    walk) is not kept."""
    if theta <= 0.0:
        return None
    key = (head_dim, theta, device)
    table = _ROPE_TABLES.get(key)
    if table is None:
        table = layers.rope_frequencies(head_dim, theta, device=device)
        if not isinstance(table, FakeTensor) and table.device.type != "meta":
            _ROPE_TABLES[key] = table
    return table


def _head(params, table, cfg: ModelConfig, ax):
    """The output head: the embedding table, or with ``tie_embeddings``
    off the ``head`` leaf, placed as the table is."""
    if cfg.tie_embeddings:
        return table
    return reshard(ax, params["head"], mp_axis(ax), None)


def _flush(x, delta):
    """The residual with the held-back delta added: for work that reads
    the residual itself (cross attention)."""
    return x + delta


def project_qkv(x, ap, cfg: ModelConfig, mp: int = 1):
    B, S, _ = x.shape
    hd = cfg.head_dim
    Hp, Kp = cfg.padded_heads(mp), cfg.replicated_kv_heads(mp)
    q = (x @ ap["wq"]).reshape(B, S, Hp, hd)
    k = (x @ ap["wk"]).reshape(B, S, Kp, hd)
    v = (x @ ap["wv"]).reshape(B, S, Kp, hd)
    return q, k, v


def _attn_core_full(q, k, v, positions, *, cfg: ModelConfig,
                    spec: LayerSpec, chunk: int, ops):
    """RoPE and the attention on one rank's heads (plain tensors: the
    kernels' ``ctypes`` launch takes nothing else).  Returns (out, k)."""
    q, k = ops.rope(q, k, positions,
                    rope_table(q.shape[-1], cfg.rope_theta, q.device))
    out = ops.attention(
        q, k, v, q_positions=positions, k_positions=positions, causal=True,
        window=spec.window, softcap=cfg.attn_logit_softcap, chunk_q=chunk,
        chunk_k=chunk, scale=_attn_scale(cfg))
    return out, k


def _self_attention_full(x, ap, cfg: ModelConfig, ax, spec: LayerSpec,
                         positions, ops, chunk: int = 1024):
    """Full-sequence (prefill) self attention.  Returns (out, k, v).
    Under a mesh the attention runs on each rank's local heads
    (:func:`~repro_torch.models.partition.local_region`)."""
    q, k, v = project_qkv(rows(ax, x), ap, cfg, mp_size(ax))
    hs = heads_spec(ax)
    q = shard(ax, q, *hs)
    k = shard(ax, k, *hs)
    v = shard(ax, v, *hs)
    core = functools.partial(_attn_core_full, cfg=cfg, spec=spec,
                             chunk=chunk, ops=ops)
    out, k = local_region(ax, core, (hs, hs, hs, None), (hs, hs))(
        q, k, v, positions)
    out = out.reshape(x.shape[0], x.shape[1], -1) @ ap["wo"]
    return out, k, v


def _decode_core(q, k, v, pos, kc, vc, pc, *scales, cfg: ModelConfig,
                 spec: LayerSpec, ops):
    """RoPE, the ring write and the attention of one decode step, on one
    rank's batch rows and heads.  kc/vc/pc (and the ``kv_quant`` scales)
    are written IN PLACE: DTensor's own rule for the indexed write would
    gather the batch first.  Returns (out,)."""
    pos = pos.to(torch.int32)
    q, k_read, v_read = ops.ring_write(
        q, k, v, pos, kc, vc, pc, scales,
        rope_table(q.shape[-1], cfg.rope_theta, q.device))
    return (ops.decode_attention(
        q, k_read, v_read, q_position=pos, k_positions=pc,
        window=spec.window, softcap=cfg.attn_logit_softcap,
        scale=_attn_scale(cfg)),)


def _self_attention_decode(x, ap, cfg: ModelConfig, ax, spec: LayerSpec,
                           ops, pos, kc, vc, pc, scales=None):
    """One-token decode.  x: [B,1,D]; kc/vc: [B,W,Kp,hd] (int8 when
    ``cfg.kv_quant``, with ``scales`` = (ks, vs) f32 [B,W,Kp]) and pc:
    [B,W] slot positions (-1 = empty) — this layer's slices of the decode
    step's private cache copy, written IN PLACE (the caller cloned the
    cache, so the table columns it came from are never touched).  pos:
    [B].  Returns out."""
    q, k, v = project_qkv(x, ap, cfg, mp_size(ax))
    hs, dp = heads_spec(ax), dp_axes(ax)
    q, k, v = (reshard(ax, t, *hs) for t in (q, k, v))
    args = [q, k, v, reshard(ax, pos, dp), kc, vc, pc]
    specs = [hs, hs, hs, P(dp), hs, hs, P(dp, None)]
    if cfg.kv_quant:
        args += list(scales)
        specs += [P(dp, None, mp_axis(ax))] * 2
    core = functools.partial(_decode_core, cfg=cfg, spec=spec, ops=ops)
    (out,) = local_region(ax, core, specs, (hs,))(*args)
    return out.reshape(x.shape[0], 1, -1) @ ap["wo"]


def _cross_core(q, mk, mv, *, cfg: ModelConfig):
    B, S = q.shape[:2]
    M = mk.shape[1]
    out = layers.chunked_attention(
        q, mk, mv,
        q_positions=torch.zeros((S,), dtype=torch.int32, device=q.device),
        k_positions=torch.arange(M, dtype=torch.int32, device=q.device),
        causal=False, window=0, softcap=0.0, chunk_q=min(1024, S),
        chunk_k=M, scale=_attn_scale(cfg))
    return (out,)


def _cross_attention(x, cp, cfg: ModelConfig, ax, media_kv):
    """Gated cross attention (plain, as in the reference).  media_kv =
    (k [B,M,Kp,hd], v [B,M,Kp,hd])."""
    B, S, _ = x.shape
    hd, Hp = cfg.head_dim, cfg.padded_heads(mp_size(ax))
    xq = rows(ax, layers.apply_norm(x, cp["ln"], cfg.norm))
    hs = heads_spec(ax)
    q = reshard(ax, (xq @ cp["wq"]).reshape(B, S, Hp, hd), *hs)
    mk, mv = (reshard(ax, t, *hs) for t in media_kv)
    core = functools.partial(_cross_core, cfg=cfg)
    (out,) = local_region(ax, core, (hs, hs, hs), (hs,))(q, mk, mv)
    out = out.reshape(B, S, -1) @ cp["wo"]
    return torch.tanh(cp["gate"]).to(x.dtype) * out


def media_kv_from_embeddings(media, cp, cfg: ModelConfig, mp: int = 1):
    """Project stub media embeddings [B,M,D] to cross-attn K/V."""
    B, M, _ = media.shape
    hd, Kp = cfg.head_dim, cfg.replicated_kv_heads(mp)
    mk = (media @ cp["wk"]).reshape(B, M, Kp, hd)
    mv = (media @ cp["wv"]).reshape(B, M, Kp, hd)
    return mk, mv


def _mlp(x, p, cfg: ModelConfig, ops):
    """``layers.mlp_apply``, a gated MLP's activation and product by
    ``ops.gated_act``."""
    if cfg.gated_mlp:
        return ops.gated_act(x @ p["w_gate"], x @ p["w_up"],
                             cfg.act) @ p["w_down"]
    return layers.mlp_apply(x, p, gated=False, act=cfg.act)


def _layer_ffn(x, lp, spec: LayerSpec, cfg: ModelConfig, ax, ops, *,
               seq_sharded: bool = False, moe_dispatch: str = "all_to_all"):
    """The FFN part: the MLP, or the MoE layer plus its ``aux_mlp``.
    Returns (y, aux): the router's load-balance loss (None for a dense
    layer), which only the training loss reads."""
    if spec.is_moe:
        with scope("moe", span=False):
            y, aux = moe_lib.moe_apply(x, lp["moe"], cfg, ax,
                                       seq_sharded=seq_sharded,
                                       dispatch=moe_dispatch, ops=ops)
        if spec.aux_mlp:
            y = y + rows(ax, _mlp(rows(ax, x), lp["aux_mlp"], cfg, ops))
        return y, aux
    return _mlp(rows(ax, x), lp["mlp"], cfg, ops), None


# ---------------------------------------------------------------------------
# full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------
def forward(params, tokens, cfg: ModelConfig, *, ax: Optional[AxisInfo] = None,
            media=None, build_cache: bool = False,
            cache_len: Optional[int] = None, long_context: bool = False,
            chunk: int = 1024, remat: bool = False, with_aux: bool = False,
            moe_dispatch: str = "all_to_all"):
    """tokens: [B, S] -> logits [B, S, V].  If ``build_cache`` also returns
    the decode cache (prefill) with ring semantics: a layer of window W
    keeps the last W positions when S >= W, else pads with -1 slots.
    ``media`` [B, M, D] feeds the cross layers (vlm); without it they are
    skipped and the cache has no ``ck``/``cv`` leaves, as in the
    reference.  ``with_aux`` appends the MoE layers' summed load-balance
    loss (f32 scalar) to the result.  ``remat`` checkpoints each block
    under ``cfg.remat_policy`` (:func:`layers.remat_block`).

    Under a mesh (``ax``) the params, tokens and media are DTensors and
    every ``shard`` site of the reference redistributes the residual
    stream: batch over data, the sequence over model with
    ``cfg.seq_shard``, the layer outputs pinned there too with
    ``cfg.rs_outputs`` (a reduce-scatter of the partial sums).

    Differentiable: the caller picks grad mode (the serving entry points
    run under ``torch.no_grad``; the training loss does not)."""
    groups = layer_groups(cfg, long_context=long_context)
    B, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    dp = dp_axes(ax)
    seq_ax = mp_axis(ax) if cfg.seq_shard else None
    table = vocab_table(params, ax)
    x = layers.embed_lookup(table, tokens, scale_by_dim=cfg.embedding_scale)
    x = shard(ax, x, dp, seq_ax, None)
    if media is not None:
        media = shard(ax, media, dp, None, None)
    seq_sharded = ax is not None and cfg.seq_shard
    ops = layer_ops.layer_ops(cfg, ax)

    def _out(t):
        """A layer's output (partial sums over model) summed into the
        residual's layout: pinned there with ``cfg.rs_outputs`` (a
        reduce-scatter), else summed into whole rows (an all-reduce),
        where the reference leaves the choice to XLA.  Either way the
        backward meets no batch-and-sequence dim split two ways."""
        if cfg.rs_outputs:
            return shard(ax, t, dp, seq_ax, None)
        return rows(ax, t)

    def block_fn(x, delta, blk, first: int, specs: List[LayerSpec]):
        """One block of a group (:func:`layer_groups`) from the residual
        ``x`` and the last layer's held-back ``delta`` (None before the
        first)."""
        auxes: List[torch.Tensor] = []
        cache_out: Dict[str, torch.Tensor] = {}
        blk = gather_fsdp(ax, blk)
        x = shard(ax, x, dp, seq_ax, None)
        for i, spec in enumerate(specs, first):
            lp = blk[str(i)]
            # ``cfg.bf16_boundary`` pins the norm's bf16 output with an
            # XLA barrier in the reference, so that XLA cannot hoist the
            # f32 upcast above the sequence-parallel all-gather.  Eager
            # ops run in program order: the gather (``rows``) always moves
            # the norm's output in the model's dtype, so the port has
            # nothing to pin, and the barrier changes no value.
            x, h = ops.add_norm(x, delta, **lp["ln1"])
            attn_out, k, v = _self_attention_full(h, lp["attn"], cfg, ax,
                                                  spec, positions, ops,
                                                  chunk=chunk)
            if cfg.post_norms:
                _, attn_out = ops.add_norm(attn_out, None, **lp["post_ln1"])
            delta = _out(attn_out)
            if spec.has_cross and media is not None:
                x = _flush(x, delta)
                mkv = media_kv_from_embeddings(media, lp["cross"], cfg,
                                               mp_size(ax))
                delta = _out(_cross_attention(x, lp["cross"], cfg, ax, mkv))
                if build_cache:
                    cache_out[f"ck{i}"], cache_out[f"cv{i}"] = mkv
            x, h = ops.add_norm(x, delta, **lp["ln2"])
            ffn_out, aux = _layer_ffn(h, lp, spec, cfg, ax, ops,
                                      seq_sharded=seq_sharded,
                                      moe_dispatch=moe_dispatch)
            if cfg.post_norms:
                _, ffn_out = ops.add_norm(ffn_out, None, **lp["post_ln2"])
            delta = _out(ffn_out)
            if aux is not None:
                auxes.append(aux)
            if build_cache:
                cache_out.update(_ring_slots(i, k, v, positions, spec, cfg,
                                             cache_len, ax))
        return x, delta, cache_out, auxes

    body = (layers.remat_block(block_fn, cfg.remat_policy) if remat
            else block_fn)
    caches: Dict[str, List[torch.Tensor]] = {}
    auxes: List[torch.Tensor] = []
    delta = None
    for first, specs, _, blk in _block_slices(params["blocks"], groups):
        x, delta, cache_out, blk_aux = body(x, delta, blk, first, specs)
        auxes += blk_aux
        for name, t in cache_out.items():
            caches.setdefault(name, []).append(t)
    _, x = ops.add_norm(x, delta, **params["final_norm"])
    logits = layers.unembed(rows(ax, x), _head(params, table, cfg, ax),
                            softcap=cfg.final_logit_softcap)
    logits = shard(ax, logits, dp, seq_ax, None)
    out = (logits,)
    if build_cache:
        out += ({k: torch.stack(v) for k, v in caches.items()},)
    if with_aux:
        out += (torch.stack(auxes).sum() if auxes else
                x.new_zeros((), dtype=torch.float32),)
    return out if len(out) > 1 else logits


def _ring_core(k, v, positions, *, i: int, spec: LayerSpec,
               cfg: ModelConfig, cache_len: Optional[int]):
    """Layer ``i``'s prefill cache leaves on one rank's rows and heads: a
    layer of window W keeps the last W positions when S >= W, else pads
    with -1 slots (int8 values and f32 scales under ``kv_quant``).
    Returns the leaves in :func:`_ring_names` order."""
    B, S = k.shape[0], k.shape[1]
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
            (pad,), -1, dtype=torch.int32, device=k.device)]).expand(B, W)
    if cfg.kv_quant:
        kq, ksc = layers.kv_quantize(ks)
        vq, vsc = layers.kv_quantize(vs)
        return ps, kq, ksc, vq, vsc
    return ps, ks, vs


def _ring_names(i: int, cfg: ModelConfig) -> Tuple[str, ...]:
    if cfg.kv_quant:
        return (f"pos{i}", f"k{i}", f"ks{i}", f"v{i}", f"vs{i}")
    return (f"pos{i}", f"k{i}", f"v{i}")


def _ring_slots(i: int, k, v, positions, spec: LayerSpec, cfg: ModelConfig,
                cache_len: Optional[int], ax=None) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s prefill cache leaves (:func:`_ring_core`), placed as
    :func:`cache_pspecs` places them without the block axis."""
    hs, dp = heads_spec(ax), dp_axes(ax)
    names = _ring_names(i, cfg)
    scale = P(dp, None, mp_axis(ax))
    leaf_spec = {"pos": P(dp, None), "k": hs, "v": hs, "ks": scale,
                 "vs": scale}
    outs = [leaf_spec[n.rstrip("0123456789")] for n in names]
    core = functools.partial(_ring_core, i=i, spec=spec, cfg=cfg,
                             cache_len=cache_len)
    return dict(zip(names, local_region(ax, core, (hs, hs, None), outs)(
        k, v, positions)))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def layer_slots(cfg: ModelConfig, *, long_context: bool = False
                ) -> List[Tuple[int, LayerSpec, int]]:
    """``(key, spec, n)`` of every stacked layer slot of
    :func:`layer_groups`, in key order: layer ``key``'s params and cache
    leaves hold ``n`` layers."""
    return [(first + i, spec, n)
            for first, specs, n in layer_groups(cfg,
                                                long_context=long_context)
            for i, spec in enumerate(specs)]


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: DeviceLike = None, *, ax: Optional[AxisInfo] = None,
               long_context: bool = False, media_tokens: int = 0):
    """Empty decode cache (stacked over blocks): zero K/V (int8 with unit
    f32 scales under ``kv_quant``), -1 positions, and zero media K/V of
    ``media_tokens`` (default ``cfg.num_media_tokens``) rows for each
    cross layer; the KV heads replicated to the mesh's model axis.
    ``device="meta"`` gives shapes and dtypes without allocating."""
    dev = resolve_device(device)
    Kp, hd = cfg.replicated_kv_heads(mp_size(ax)), cfg.head_dim
    dtype = torch_dtype(cfg.dtype)
    kv_dtype = torch.int8 if cfg.kv_quant else dtype
    cache = {}
    for i, spec, n_blocks in layer_slots(cfg, long_context=long_context):
        W = min(spec.window, cache_len) if spec.window else cache_len
        cache[f"k{i}"] = torch.zeros((n_blocks, batch, W, Kp, hd),
                                     dtype=kv_dtype, device=dev)
        cache[f"v{i}"] = torch.zeros((n_blocks, batch, W, Kp, hd),
                                     dtype=kv_dtype, device=dev)
        cache[f"pos{i}"] = torch.full((n_blocks, batch, W), -1,
                                      dtype=torch.int32, device=dev)
        if cfg.kv_quant:
            cache[f"ks{i}"] = torch.ones((n_blocks, batch, W, Kp),
                                         dtype=torch.float32, device=dev)
            cache[f"vs{i}"] = torch.ones((n_blocks, batch, W, Kp),
                                         dtype=torch.float32, device=dev)
        if spec.has_cross:
            M = media_tokens or cfg.num_media_tokens
            cache[f"ck{i}"] = torch.zeros((n_blocks, batch, M, Kp, hd),
                                          dtype=dtype, device=dev)
            cache[f"cv{i}"] = torch.zeros((n_blocks, batch, M, Kp, hd),
                                          dtype=dtype, device=dev)
    return cache


def cache_pspecs(cfg: ModelConfig, ax: AxisInfo, *,
                 long_context: bool = False) -> Dict[str, P]:
    """Partition specs matching :func:`init_cache`: batch over data,
    KV heads over model."""
    out = {}
    dp, mp = ax.batch, ax.model
    for i, spec, _ in layer_slots(cfg, long_context=long_context):
        out[f"k{i}"] = P(None, dp, None, mp, None)
        out[f"v{i}"] = P(None, dp, None, mp, None)
        out[f"pos{i}"] = P(None, dp, None)
        if cfg.kv_quant:
            out[f"ks{i}"] = P(None, dp, None, mp)
            out[f"vs{i}"] = P(None, dp, None, mp)
        if spec.has_cross:
            out[f"ck{i}"] = P(None, dp, None, mp, None)
            out[f"cv{i}"] = P(None, dp, None, mp, None)
    return out


#: cache leaves a decode step reads and never writes (the media K/V)
_READ_ONLY = ("ck", "cv")


@torch.no_grad()
def decode_step(params, tokens, pos, cache, cfg: ModelConfig, *,
                ax: Optional[AxisInfo] = None, long_context: bool = False,
                moe_dispatch: str = "all_to_all"):
    """tokens: [B, 1]; pos: [B] absolute position of the new token.
    Returns (logits [B, 1, V], new_cache).  The input cache is left as it
    was: the step writes its new slots into a copy (the reference's
    ``.at[].set`` is functional, and the cache tensors may be views of
    table columns that other consumers share); the media K/V, which no
    step writes, are passed on as they are.  Under a mesh the cache
    leaves are DTensors placed by :func:`cache_pspecs`, and each rank
    writes its own rows and heads."""
    groups = layer_groups(cfg, long_context=long_context)
    new_cache = {k: v if k.startswith(_READ_ONLY) else v.clone()
                 for k, v in cache.items()}
    dp = dp_axes(ax)
    ops = layer_ops.layer_ops(cfg, ax)
    table = vocab_table(params, ax)
    x = layers.embed_lookup(table, tokens, scale_by_dim=cfg.embedding_scale)
    x = shard(ax, x, dp, None, None)
    delta = None        # the held-back residual add
    for first, specs, j, blk in _block_slices(params["blocks"], groups):
        blk = gather_fsdp(ax, blk)
        x = shard(ax, x, dp, None, None)
        for i, spec in enumerate(specs, first):
            lp = blk[str(i)]
            x, h = ops.add_norm(x, delta, **lp["ln1"])
            scales = ((new_cache[f"ks{i}"][j], new_cache[f"vs{i}"][j])
                      if cfg.kv_quant else None)
            delta = _self_attention_decode(
                h, lp["attn"], cfg, ax, spec, ops, pos,
                new_cache[f"k{i}"][j], new_cache[f"v{i}"][j],
                new_cache[f"pos{i}"][j], scales)
            if cfg.post_norms:
                _, delta = ops.add_norm(delta, None, **lp["post_ln1"])
            if spec.has_cross:
                x = _flush(x, delta)
                mkv = (new_cache[f"ck{i}"][j], new_cache[f"cv{i}"][j])
                delta = _cross_attention(x, lp["cross"], cfg, ax, mkv)
            x, h = ops.add_norm(x, delta, **lp["ln2"])
            delta, _ = _layer_ffn(h, lp, spec, cfg, ax, ops,
                                  moe_dispatch=moe_dispatch)
            if cfg.post_norms:
                _, delta = ops.add_norm(delta, None, **lp["post_ln2"])
    _, x = ops.add_norm(x, delta, **params["final_norm"])
    logits = layers.unembed(rows(ax, x), _head(params, table, cfg, ax),
                            softcap=cfg.final_logit_softcap)
    return logits, new_cache
