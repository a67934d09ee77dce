"""Google RecurrentGemma-2B (Griffin) — RG-LRU + local attention 2:1.
[arXiv:2402.19427]

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.  Pattern: two
RG-LRU recurrent blocks (temporal conv width 4) then one 2048-window local
attention block.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    source="arXiv:2402.19427",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    rnn_width=2560,
    conv_width=4,
    attn_layer_period=3,     # layers 2,5,8,... are local attention
    sliding_window=2048,
    embedding_scale=True,
    act="gelu",
)


def tiny() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="rgemma-tiny", num_layers=6, d_model=128, num_heads=4,
        num_kv_heads=1, head_dim=32, d_ff=256, vocab_size=512, rnn_width=128,
        sliding_window=32)
