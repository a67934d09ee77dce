"""IBM Granite-34B-Code — deep llama-arch MQA. [arXiv:2405.04324]

88L d_model=6144 48H (GQA kv=1, i.e. MQA) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    gated_mlp=False,
    rope_theta=10_000.0,
)


def tiny() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="granite-tiny", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=1, head_dim=32, d_ff=384, vocab_size=512)
