"""Base model configuration for the repro model zoo.

Every assigned architecture gets one file in this package exposing a module-
level ``CONFIG: ModelConfig`` with the exact numbers from the assignment
(citation in the ``source`` field) plus a ``tiny()`` reduced variant used by
the per-arch smoke tests (2 layers, d_model <= 512, <= 4 experts).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description consumed by ``repro_torch.models.registry``.

    The fields cover all six assigned families: dense / moe / ssm / hybrid /
    vlm / audio.  Family-specific fields are ignored by other families.
    ``tie_embeddings`` is read by the transformer families: off, the output
    head is a ``head`` leaf of its own (deepseek-moe-16b), else the
    embedding table.
    """

    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    source: str                       # citation (arXiv / HF model card)

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0                # 0 for attention-free (rwkv)
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 128

    # --- attention behaviour ---
    rope_theta: float = 10_000.0
    sliding_window: int = 0           # 0 = full attention
    local_global_pattern: int = 0     # gemma2: every Nth layer is global (N=2)
    attn_logit_softcap: float = 0.0   # gemma2: 50.0
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    # long-context decode: serve "global" layers with a window (DESIGN §5)
    long_context_windowed: bool = False

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0      # top-k
    moe_layer_period: int = 1         # llama4: 2 (every other layer is MoE)
    dense_residual: bool = False      # arctic: parallel dense FFN in MoE layers
    shared_expert: bool = False       # llama4: one always-on expert
    expert_d_ff: int = 0              # defaults to d_ff
    # deepseek-moe: the first k layers keep a dense FFN (d_ff wide) before
    # the MoE pattern starts (``first_k_dense_replace``)
    first_k_dense: int = 0
    # the always-on MLP's width (shared experts / dense residual), d_ff
    # when 0; deepseek-moe's two shared experts of 1408 are one of 2816
    shared_expert_d_ff: int = 0
    # renormalise the k routing weights to sum to 1 (arctic, llama4); off,
    # a token keeps its k softmax probabilities (``norm_topk_prob``)
    norm_topk_prob: bool = True
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01

    # --- SSM / hybrid ---
    rnn_width: int = 0                # rglru recurrent width (default d_model)
    conv_width: int = 4               # temporal conv window (rglru)
    attn_layer_period: int = 0        # recurrentgemma: every 3rd layer is attn
    rwkv_head_dim: int = 64

    # --- vlm / audio (frontends are stubs per DESIGN §4) ---
    cross_attn_period: int = 0        # llama3.2-vision: every 5th layer
    num_media_tokens: int = 0         # stub patch/frame embedding count
    encoder_layers: int = 0           # whisper: encoder depth
    encoder_seq: int = 0              # whisper: 1500 frames
    is_encoder_decoder: bool = False

    # --- norms / misc ---
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    post_norms: bool = False          # gemma2 post-attn/post-ffn norms
    act: str = "silu"                 # silu | gelu
    gated_mlp: bool = True            # 3-matrix SwiGLU vs 2-matrix MLP
    # the output head is the embedding table; False adds a separate
    # ``head`` leaf [padded_vocab, d_model] (``models/transformer.py``)
    tie_embeddings: bool = True
    embedding_scale: bool = False     # gemma-style sqrt(d) input scaling
    dtype: str = "bfloat16"

    # --- training ---
    optimizer: str = "adamw"          # adamw | adafactor (giant MoEs)
    remat_policy: str = "nothing"     # nothing | dots | everything
    grad_accum: int = 1               # microbatch accumulation steps
    accum_dtype: str = "float32"      # bf16 for 480B-class (memory, DESIGN §4)

    # --- kernels ---
    use_kernels: bool = False         # CUDA kernels (plain version on CPU)
    kv_quant: bool = False            # int8 KV cache (beyond-paper, §Perf C)
    expert_quant: bool = False        # int8 expert weights (serving, §Perf A)
    bf16_boundary: bool = False       # pin bf16 at reshard boundaries (§Perf B)
    seq_shard: bool = True            # sequence-parallel residual (§Perf B alt)
    rs_outputs: bool = False          # constrain layer outputs seq-sharded
                                      # to induce reduce-scatter (§Perf B)
    causal_skip: bool = False         # triangle-pair chunked attention
                                      # (skip masked chunks, §Perf prefill)

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def mlp_mats(self) -> int:
        return 3 if self.gated_mlp else 2

    @property
    def expert_ff(self) -> int:
        return self.expert_d_ff or self.d_ff

    @property
    def aux_ff(self) -> int:
        """Width of a MoE layer's always-on MLP (``aux_mlp``)."""
        return self.shared_expert_d_ff or self.d_ff

    def is_moe_layer(self, layer: int) -> bool:
        """Whether layer ``layer`` (from 0) has a MoE FFN: past the
        ``first_k_dense`` dense layers, the last of every
        ``moe_layer_period``."""
        if self.num_experts == 0 or layer < self.first_k_dense:
            return False
        p = self.moe_layer_period
        return (layer - self.first_k_dense) % p == p - 1

    @property
    def rnn_dim(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def num_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def padded_heads(self, model_axis: int) -> int:
        """Q heads padded to a multiple of the model-parallel axis."""
        if self.num_heads == 0:
            return 0
        return _round_up(self.num_heads, model_axis)

    def replicated_kv_heads(self, model_axis: int) -> int:
        """KV heads replicated Megatron-style to a multiple of model axis."""
        if self.num_kv_heads == 0:
            return 0
        if self.num_kv_heads >= model_axis:
            return _round_up(self.num_kv_heads, model_axis)
        return model_axis

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (unpadded heads, untied count once)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.head_dim
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += V * D
        for layer in range(L):
            if self.family == "ssm":  # rwkv6
                n += 4 * D * D + int(2.5 * D * D)  # time-mix r,k,v,o,g + loras
                n += 2 * D * self.d_ff             # channel mix
                n += 2 * D
                continue
            is_attn = True
            if self.family == "hybrid" and self.attn_layer_period:
                is_attn = (layer % self.attn_layer_period) == (
                    self.attn_layer_period - 1)
            if is_attn and self.num_heads:
                n += D * self.num_heads * hd               # wq
                n += 2 * D * self.num_kv_heads * hd        # wk, wv
                n += self.num_heads * hd * D               # wo
            elif self.family == "hybrid":
                R = self.rnn_dim
                n += 2 * D * R + R * D + R * self.conv_width + 2 * R * R // 8
            if self.is_moe_layer(layer):
                n += D * self.num_experts                   # router
                n += self.num_experts * self.mlp_mats * D * self.expert_ff
                if self.dense_residual or self.shared_expert:
                    n += self.mlp_mats * D * self.aux_ff
            else:
                n += self.mlp_mats * D * F
            if self.cross_attn_period and (layer % self.cross_attn_period
                                           == self.cross_attn_period - 1):
                n += 2 * D * self.num_heads * hd
                n += 2 * D * self.num_kv_heads * hd
            n += 2 * D                                      # norms
        if self.is_encoder_decoder:
            # encoder layers: self-attn + ffn; decoder cross-attn counted here
            n += self.encoder_layers * (4 * D * D + 2 * D * self.d_ff + 2 * D)
            n += self.num_layers * (4 * D * D)              # decoder cross-attn
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k) for MODEL_FLOPS = 6*N_active*D."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        # subtract inactive expert params
        moe_layers = sum(1 for layer in range(self.num_layers)
                         if self.is_moe_layer(layer))
        per_expert = self.mlp_mats * self.d_model * self.expert_ff
        inactive = moe_layers * (self.num_experts
                                 - self.num_experts_per_tok) * per_expert
        return full - inactive

    def validate(self) -> None:
        assert self.family in ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
        if self.family != "ssm":
            assert self.num_heads > 0 and self.head_dim > 0
        if self.num_experts:
            assert self.num_experts_per_tok >= 1
        assert self.d_model > 0 and self.num_layers > 0 and self.vocab_size > 0
        assert 0 <= self.first_k_dense < self.num_layers


def human(n: float) -> str:
    for unit in ("", "K", "M", "B", "T"):
        if abs(n) < 1000:
            return f"{n:.1f}{unit}"
        n /= 1000
    return f"{n:.1f}P"
