"""Google Gemma-2 9B — alternating local/global attention, logit softcaps.
[arXiv:2408.00118]

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.  Odd layers are
global, even layers use a 4096 sliding window; attention-logit softcap 50,
final-logit softcap 30; gemma-style post-norms and sqrt(d) embedding scale.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    source="arXiv:2408.00118",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    rope_theta=10_000.0,
    sliding_window=4096,
    local_global_pattern=2,        # every 2nd layer global, others local
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_norms=True,
    embedding_scale=True,
    act="gelu",
    long_context_windowed=True,    # DESIGN §5: windowed globals for long_500k
)


def tiny() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="gemma2-tiny", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=384, vocab_size=512,
        sliding_window=64)
