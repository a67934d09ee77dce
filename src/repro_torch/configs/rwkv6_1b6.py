"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay.
[arXiv:2404.05892]

24L d_model=2048 (attn-free; 32 wkv heads of dim 64) d_ff=7168 vocab=65536.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=24,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
    norm="layernorm",
)


def tiny() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="rwkv6-tiny", num_layers=2, d_model=128, d_ff=256,
        vocab_size=512, rwkv_head_dim=32)
