"""Meta Llama-4 Maverick 400B-A17B — interleaved MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048; MoE 128 experts top-1
on every 2nd layer plus a shared expert (matches the 400B total / 17B active
and the Llama-4 interleave).  Early fusion: image tokens from the stub
frontend are interleaved in the input sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    num_experts_per_tok=1,
    moe_layer_period=2,      # every other layer is MoE
    shared_expert=True,
    expert_d_ff=8192,
    rope_theta=500_000.0,
    optimizer="adafactor",
    grad_accum=8,                # fits 480B-class train under 16GB/chip
    accum_dtype="bfloat16",
    remat_policy="nothing",
)


def tiny() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="llama4-tiny", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, expert_d_ff=256, vocab_size=512,
        num_experts=4, num_experts_per_tok=1, optimizer="adamw",
        grad_accum=1, accum_dtype="float32")
