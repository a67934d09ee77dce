"""Snowflake Arctic 480B — dense-MoE hybrid. [hf:Snowflake/snowflake-arctic-base]

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128 experts top-2
with a parallel dense residual FFN on every layer.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    num_experts_per_tok=2,
    moe_layer_period=1,
    dense_residual=True,
    expert_d_ff=4864,
    rope_theta=10_000.0,
    optimizer="adafactor",       # AdamW m+v at 480B does not fit 16GB/chip
    grad_accum=8,                # fits 480B-class train under 16GB/chip
    accum_dtype="bfloat16",
    remat_policy="nothing",
)


def tiny() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="arctic-tiny", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, expert_d_ff=256, vocab_size=512,
        num_experts=4, num_experts_per_tok=2, optimizer="adamw",
        grad_accum=1, accum_dtype="float32")
