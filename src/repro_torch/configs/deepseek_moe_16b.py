"""DeepSeekMoE 16B — fine-grained routed experts plus shared experts after
a dense first layer.  [hf:deepseek-ai/deepseek-moe-16b-base; arXiv:2401.06066]

28L d_model=2048 16H (MHA, kv=16) head_dim=128 vocab=102400, untied head.
Layer 0 is a dense SwiGLU of 10944 (``first_k_dense_replace`` 1); layers
1-27 route each token to the top 6 of 64 SwiGLU experts of 1408 by
softmax, without renormalising the six weights (``norm_topk_prob``
false), and add 2 shared experts of 1408, served as one SwiGLU of 2816
(their gate and up columns and their down rows concatenated: the same
function).  RoPE base 10000, RMSNorm eps 1e-6, 4096 positions.

Not in the reference package: the port serves it alone, and the CPU tests
hold it to the plain float32 forward in
:mod:`repro_torch.reference.deepseek_moe`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="hf:deepseek-ai/deepseek-moe-16b-base",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,
    vocab_size=102400,
    num_experts=64,
    num_experts_per_tok=6,
    moe_layer_period=1,
    shared_expert=True,
    expert_d_ff=1408,
    first_k_dense=1,
    shared_expert_d_ff=2816,
    norm_topk_prob=False,
    router_aux_loss_coef=0.001,
    rope_theta=10_000.0,
    tie_embeddings=False,
)


def tiny() -> ModelConfig:
    """One dense layer and two MoE layers of 8 experts, top 3: the
    structure of the published model (dense prefix, shared experts, no
    renormalisation, separate head) at widths a CPU test runs."""
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="deepseek-moe-tiny", num_layers=3, d_model=128,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, expert_d_ff=64,
        shared_expert_d_ff=128, vocab_size=512, num_experts=8,
        num_experts_per_tok=3)
