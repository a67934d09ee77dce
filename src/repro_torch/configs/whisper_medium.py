"""OpenAI Whisper-medium — encoder-decoder with conv/mel frontend stub.
[arXiv:2212.04356]

24L (decoder) d_model=1024 16H (kv=16, i.e. MHA) d_ff=4096 vocab=51865, plus a
24L encoder over 1500 stub frame embeddings (the mel+conv frontend is the
allowed stub; ``input_specs`` supplies (B, 1500, 1024) frames).
vocab padded 51865 -> 51968 for SPMD divisibility (DESIGN §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    gated_mlp=False,
    is_encoder_decoder=True,
    encoder_layers=24,
    encoder_seq=1500,
    norm="layernorm",
    act="gelu",
    rope_theta=0.0,          # whisper uses learned/sinusoidal positions
)


def tiny() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="whisper-tiny", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        encoder_layers=2, encoder_seq=64)
