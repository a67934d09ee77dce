"""Analytic executed-FLOPs / HBM-bytes model (port of the reference
package's ``roofline/flops.py``; the same arithmetic in the same order,
so it gives the reference's numbers for every config and shape).

The estimate models the REFERENCE's implementation, overheads included:

* padded Q-heads / replicated KV-heads (SPMD divisibility)
* chunked attention computes ALL nq*nk chunk pairs (masked, not skipped)
* MoE: every expert over every token at ``mp <= 1`` (the masked combine),
  capacity padding (``capacity_factor``) under model parallelism; router
* remat recompute (+1 forward for policy "nothing")
* padded vocab

The port executes less than this for attention and MoE: its flash
kernels skip the key tiles no query row of a tile needs, and the served
``moe_apply`` runs only the routed experts.  ``step_flops`` is therefore
an upper count of the port's work, not the port's own.

MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*D (inference) does not
depend on the implementation: it is the numerator of an MFU;
useful_ratio = MODEL_FLOPS / executed.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models.transformer import LayerSpec, layer_slots
from repro_torch.models import rglru as rglru_lib


@dataclasses.dataclass
class CostEstimate:
    fwd_flops: float = 0.0          # global forward FLOPs
    step_flops: float = 0.0         # global executed FLOPs for the step
    model_flops: float = 0.0        # 6*N_active*tokens (or 2* for inference)
    weight_bytes: int = 0           # global param bytes (padded)
    cache_bytes: int = 0            # global decode-cache bytes
    hbm_bytes_per_chip: float = 0.0 # first-order per-chip traffic / step
    act_bytes: float = 0.0

    def to_dict(self):
        return dataclasses.asdict(self)


def _attn_layer_flops(cfg: ModelConfig, T: float, S_ctx: float, mp: int,
                      window: int, decode: bool) -> float:
    """Per-layer attention FLOPs over T tokens with context S_ctx."""
    hd = cfg.head_dim
    Hp = cfg.padded_heads(mp)
    Kp = cfg.replicated_kv_heads(mp)
    D = cfg.d_model
    proj = 2 * T * D * (Hp + 2 * Kp) * hd + 2 * T * Hp * hd * D
    if decode:
        ctx = min(window, S_ctx) if window else S_ctx
        scores = 2 * T * Hp * hd * ctx * 2
    else:
        # chunked implementation computes all nq*nk chunk pairs unless the
        # triangle-pair path is enabled (causal_skip: ~(n+1)/2n of the work)
        frac = 1.0
        if cfg.causal_skip and not window:
            n = max(1, S_ctx // 1024)
            frac = (n + 1) / (2 * n)
        scores = 2 * T * Hp * hd * S_ctx * 2 * frac
    return proj + scores


def _mlp_flops(cfg: ModelConfig, T: float, F: int = 0) -> float:
    return 2 * T * cfg.d_model * (F or cfg.d_ff) * cfg.mlp_mats


def _moe_flops(cfg: ModelConfig, T: float, chips: int, mp: int,
               decode: bool) -> float:
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    D, F = cfg.d_model, cfg.expert_ff
    router = 2 * T * D * E
    if mp <= 1:
        # reference path: every expert over all tokens
        expert_tokens = T * E
    else:
        dp = max(1, chips // mp)
        T_loc = max(1.0, T / chips) if not decode else max(
            1.0, math.ceil(T / dp / mp))
        C = max(1, math.ceil(T_loc * k * cfg.capacity_factor / E))
        expert_tokens = chips * E * C   # each chip computes E*C padded slots
    return router + 2 * expert_tokens * D * F * cfg.mlp_mats


def _rwkv_layer_flops(cfg: ModelConfig, T: float) -> float:
    D, F = cfg.d_model, cfg.d_ff
    tm = 2 * T * D * D * 5                 # r,k,v,g,o projections
    lora = 2 * T * D * (5 * 32 + 64) * 2
    wkv = 4 * T * D * cfg.rwkv_head_dim    # state outer/dot/decay per channel
    cm = 2 * T * (2 * D * F + D * D)
    return tm + lora + wkv + cm


def _rglru_rec_flops(cfg: ModelConfig, T: float) -> float:
    D, R = cfg.d_model, cfg.rnn_dim
    return (2 * T * D * R * 2 + 2 * T * R * D + 2 * T * R * cfg.conv_width
            + 12 * T * R)


def _layer_slots(cfg: ModelConfig, long_context: bool):
    """``layer_slots``, and for the audio family the single plain layer
    per block that the reference's layout gives any family it does not
    name (the port's ``layer_slots`` refuses non-transformer families)."""
    if cfg.family == "audio":
        return [(0, LayerSpec(), cfg.num_layers)]
    return layer_slots(cfg, long_context=long_context)


def estimate(cfg: ModelConfig, shape: InputShape, *, chips: int = 256,
             mp: int = 16, long_context: bool = False,
             moe_dispatch: str = "all_to_all") -> CostEstimate:
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    T = B * (1 if decode else S)
    S_ctx = S
    est = CostEstimate()
    D = cfg.d_model
    Vp = cfg.padded_vocab
    fwd = 0.0

    if cfg.family in ("dense", "moe", "vlm"):
        for _, spec, n_blocks in layer_slots(cfg,
                                             long_context=long_context):
            fwd += n_blocks * _attn_layer_flops(cfg, T, S_ctx, mp,
                                                spec.window, decode)
            if spec.is_moe:
                fwd += n_blocks * _moe_flops(cfg, T, chips, mp, decode)
                if spec.aux_mlp:
                    fwd += n_blocks * _mlp_flops(cfg, T, cfg.aux_ff)
            else:
                fwd += n_blocks * _mlp_flops(cfg, T)
            if spec.has_cross:
                M = cfg.num_media_tokens
                hd, Hp = cfg.head_dim, cfg.padded_heads(mp)
                Kp = cfg.replicated_kv_heads(mp)
                fwd += n_blocks * (2 * T * D * Hp * hd           # q proj
                                   + 2 * B * M * D * 2 * Kp * hd  # kv proj
                                   + 2 * T * Hp * hd * M * 2      # attn
                                   + 2 * T * Hp * hd * D)         # out proj
    elif cfg.family == "ssm":
        fwd += cfg.num_layers * _rwkv_layer_flops(cfg, T)
    elif cfg.family == "hybrid":
        for kind in rglru_lib.layer_types(cfg):
            if kind == "rec":
                fwd += _rglru_rec_flops(cfg, T)
            else:
                fwd += _attn_layer_flops(cfg, T, S_ctx, mp,
                                         cfg.sliding_window, decode)
            fwd += _mlp_flops(cfg, T)
    elif cfg.family == "audio":
        Te = B * cfg.encoder_seq
        for _ in range(cfg.encoder_layers):
            fwd += _attn_layer_flops(cfg, Te, cfg.encoder_seq, mp, 0, False)
            fwd += _mlp_flops(cfg, Te)
        for _ in range(cfg.num_layers):
            fwd += _attn_layer_flops(cfg, T, S_ctx, mp, 0, decode)
            # cross attention (+ enc kv proj when not cached)
            hd, Hp = cfg.head_dim, cfg.padded_heads(mp)
            Kp = cfg.replicated_kv_heads(mp)
            fwd += 2 * T * D * (Hp + Hp) * hd
            fwd += 2 * T * Hp * hd * cfg.encoder_seq * 2
            if not decode:
                fwd += 2 * Te * D * 2 * Kp * hd
            fwd += _mlp_flops(cfg, T)

    # embedding / head / loss
    fwd += 2 * T * D * Vp
    if shape.kind == "train":
        fwd += 5 * T * Vp

    est.fwd_flops = fwd
    if shape.kind == "train":
        remat_extra = 1.0 if cfg.remat_policy == "nothing" else 0.0
        est.step_flops = fwd * (3.0 + remat_extra)
    else:
        est.step_flops = fwd
    n_active = cfg.active_param_count()
    mult = 6 if shape.kind == "train" else 2
    est.model_flops = float(mult * n_active * T)

    # ---- bytes ----
    bpe = 2  # bf16
    kv_bpe = 1.03 if cfg.kv_quant else 2  # int8 + per-(slot,head) f32 scale
    n_params_padded = cfg.param_count()  # padding delta is small; first-order
    est.weight_bytes = n_params_padded * bpe
    if decode:
        Kp = cfg.replicated_kv_heads(mp)
        hd = cfg.head_dim
        if cfg.family == "ssm":
            est.cache_bytes = cfg.num_layers * B * D * cfg.rwkv_head_dim * 4
        elif cfg.family == "hybrid":
            n_attn = sum(1 for k in rglru_lib.layer_types(cfg)
                         if k == "attn")
            W = min(cfg.sliding_window or S, S)
            est.cache_bytes = n_attn * B * W * Kp * hd * 2 * bpe
            est.cache_bytes += (cfg.num_layers - n_attn) * B * cfg.rnn_dim * 4
        else:
            for _, spec, n_blocks in _layer_slots(cfg, long_context):
                W = min(spec.window or S, S)
                est.cache_bytes += int(n_blocks * B * W * Kp * hd * 2
                                       * kv_bpe)
    # first-order per-chip traffic: weights touched + cache + activations
    act_per_token = D * 12 * bpe  # ~12 residual-sized tensors per layer
    layers_eff = cfg.num_layers + cfg.encoder_layers
    if shape.kind == "train":
        passes = 3 + (1 if cfg.remat_policy == "nothing" else 0)
        state_mult = 3  # params r/w + opt state r/w (approx, ZeRO-sharded)
        est.act_bytes = T * act_per_token * layers_eff * passes / chips
        est.hbm_bytes_per_chip = (
            est.weight_bytes * (passes + state_mult) / chips + est.act_bytes)
    elif shape.kind == "prefill":
        est.act_bytes = T * act_per_token * layers_eff / chips
        est.hbm_bytes_per_chip = est.weight_bytes / chips + est.act_bytes
    else:
        est.act_bytes = T * act_per_token * layers_eff / chips
        est.hbm_bytes_per_chip = (est.weight_bytes / chips
                                  + est.cache_bytes / chips + est.act_bytes)
    return est
