"""whisper-medium — encoder-decoder audio transformer; conv frontend is a
stub (input_specs() provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]

Decode shapes drive the *decoder* (decoder self-attn KV cache of seq_len,
cross-attention over the fixed 1500-frame encoder output).
"""
from .base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_kind="whisper",
    n_layers=24,                    # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    qkv_bias=True,
    tie_embeddings=True,
    encdec=EncDecConfig(encoder_layers=24, encoder_seq=1500),
    remat="none",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=16, d_ff=128, vocab=512, max_seq=64,
                          encdec=EncDecConfig(encoder_layers=2,
                                              encoder_seq=30))
