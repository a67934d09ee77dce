"""Meta Llama-3.2-Vision 11B — cross-attention image layers.
[hf:meta-llama/Llama-3.2-11B-Vision]

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; every 5th layer has a
gated cross-attention block over vision patch embeddings (STUB frontend —
``input_specs`` supplies precomputed patch embeddings, DESIGN §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_period=5,
    num_media_tokens=1601,   # 1 tile x (1600 patches + cls) from the stub ViT
)


def tiny() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="llama32v-tiny", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=384, vocab_size=512,
        cross_attn_period=2, num_media_tokens=16)
