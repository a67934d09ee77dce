"""The one choice between each hand-written kernel and its plain version
for a decoder layer's ops (``models/transformer.py``, ``models/moe.py``).

:func:`layer_ops` makes it once a ``forward`` or ``decode_step`` call; the
layers call the fields of its record and run one code path.  The table:

* ``attention``, ``decode_attention``: the kernels with ``use_kernels``,
  also under a mesh (inside ``local_region``); else ``layers``' own.
* :data:`GLUE` (``kernels/glue.py``): the kernels with ``use_kernels``, no
  mesh, rmsnorm and no ``kv_quant``; else the plain versions, and with
  ``kv_quant`` the int8 ring's write.
* :data:`MOE` (``kernels/moe.py``, ``glue.gated_act``): the kernels with
  ``use_kernels`` and no mesh; else the plain versions.

On CPU and fake tensors each wrapper runs its plain version itself.
Every path holds a residual add back (``delta``) for the next norm's
``add_norm``, whose plain versions add it and then norm the sum.
Callers reach :func:`layer_ops` through this module, so a check can put
a plain or mixed record in its place (:func:`with_plain`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import glue, moe as kmoe, ops as kops
from repro_torch.models import layers
from repro_torch.models.partition import AxisInfo

GLUE = ("add_norm", "rope", "ring_write", "gated_act")
MOE = ("moe_route", "moe_permute", "moe_act", "moe_combine")


@dataclasses.dataclass(frozen=True)
class LayerOps:
    add_norm: Callable          # (x, delta, **norm params) -> (x, h)
    rope: Callable              # (q, k, positions, freqs) -> (q, k)
    ring_write: Callable        # (q, k, v, pos, kc, vc, pc, scales, freqs)
    #                             -> (q, the rings to read)
    gated_act: Callable         # (gate, up, act)
    attention: Callable         # as layers.chunked_attention
    decode_attention: Callable  # as layers.decode_attention
    moe_route: Callable         # (xf, router_w, k, renorm) -> Routes
    moe_permute: Callable       # (xf, routes) -> (rows, pos)
    moe_act: Callable           # (gate, up, act)
    moe_combine: Callable       # (out_rows, routes, pos)


def layer_ops(cfg: ModelConfig, ax: Optional[AxisInfo]) -> LayerOps:
    """The record of ``cfg``'s layers, under a mesh where ``ax`` is given
    (the module docstring's table)."""
    glue_k = (cfg.use_kernels and ax is None and cfg.norm == "rmsnorm"
              and not cfg.kv_quant)
    moe_k = cfg.use_kernels and ax is None
    return LayerOps(
        add_norm=(glue.add_rmsnorm if glue_k else glue.add_rmsnorm_plain
                  if cfg.norm == "rmsnorm" else add_layernorm_plain),
        rope=glue.rope if glue_k else glue.rope_plain,
        ring_write=(ring_write_int8 if cfg.kv_quant else
                    ring_write if glue_k else ring_write_plain),
        gated_act=glue.gated_act if glue_k else glue.gated_act_plain,
        attention=(flash_attention if cfg.use_kernels
                   else layers.chunked_attention),
        decode_attention=(decode_attention if cfg.use_kernels
                          else layers.decode_attention),
        moe_route=kmoe.moe_route if moe_k else kmoe.moe_route_plain,
        moe_permute=kmoe.moe_permute if moe_k else kmoe.moe_permute_plain,
        moe_act=glue.gated_act if moe_k else glue.gated_act_plain,
        moe_combine=kmoe.moe_combine if moe_k else kmoe.moe_combine_plain)


def with_plain(fields: Sequence[str]) -> Callable:
    """A stand-in for :func:`layer_ops` whose records give ``fields``
    (say :data:`GLUE`) the plain versions ``use_kernels=False`` gives
    them: the glue or the MoE eager beside the other kernels."""
    choose = layer_ops

    def mixed(cfg: ModelConfig, ax: Optional[AxisInfo]) -> LayerOps:
        plain = choose(dataclasses.replace(cfg, use_kernels=False), ax)
        return dataclasses.replace(choose(cfg, ax), **{
            f: getattr(plain, f) for f in fields})
    return mixed


def add_layernorm_plain(x, delta, scale, bias):
    """``x + delta`` (x without delta) and its layernorm."""
    if delta is not None:
        x = x + delta
    return x, layers.layernorm(x, scale, bias)


def ring_write(q, k, v, pos, kc, vc, pc, scales, freqs):
    return glue.rope_cache_write(q, k, v, pos, kc, vc, pc, freqs), kc, vc


def ring_write_plain(q, k, v, pos, kc, vc, pc, scales, freqs):
    return (glue.rope_cache_write_plain(q, k, v, pos, kc, vc, pc, freqs),
            kc, vc)


def ring_write_int8(q, k, v, pos, kc, vc, pc, scales, freqs):
    """``kv_quant``'s ring: q and k rotated, the new key and value
    quantized into slot ``pos % W`` of the int8 rings and their f32
    ``scales`` (ks, vs), IN PLACE, and the whole rings dequantized to
    read, in the reference's order."""
    q = layers.apply_rope(q, pos[:, None], 0.0, freqs)
    k = layers.apply_rope(k, pos[:, None], 0.0, freqs)
    W = kc.shape[1]
    slot = (pos % W).long()                                       # [B]
    b_idx = torch.arange(q.shape[0], device=q.device)
    ks, vs = scales
    kq, ksc = layers.kv_quantize(k[:, 0])
    vq, vsc = layers.kv_quantize(v[:, 0])
    kc[b_idx, slot] = kq
    vc[b_idx, slot] = vq
    ks[b_idx, slot] = ksc
    vs[b_idx, slot] = vsc
    pc[b_idx, slot] = pos.to(pc.dtype)
    return (q, layers.kv_dequantize(kc, ks, k.dtype),
            layers.kv_dequantize(vc, vs, v.dtype))


def flash_attention(q, k, v, *, q_positions, k_positions, causal, window,
                    softcap, chunk_q, chunk_k, scale):
    """The kernel on [B, S, H, hd] q and [B, S, K, hd] k, v at positions
    0..S-1 (the plain call's positions and chunks are not read), through
    [B, H, S, hd] views: the kernel reads strides."""
    return kops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, softcap=softcap,
        scale=scale).transpose(1, 2)


def decode_attention(q, k_cache, v_cache, *, q_position, k_positions,
                     window, softcap, scale):
    """The kernel on q [B, 1, H, hd] and rings [B, W, K, hd], through
    [B, K, W, hd] views; q_position int32."""
    return kops.decode_attention(
        q[:, 0], k_cache.transpose(1, 2), v_cache.transpose(1, 2),
        k_positions, q_position, window=window, softcap=softcap,
        scale=scale)[:, None]
