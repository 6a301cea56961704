"""command-r-35b — dense GQA, no biases, parallel attn∥FFN block.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    arch_kind="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    head_dim=128,
    parallel_block=True,            # Cohere block: x + attn(ln x) + ffn(ln x)
    tie_embeddings=True,            # command-r ties in/out embeddings
    rope_theta=8e6,
    remat="full",
    rules_overrides=(("kv_heads", None),),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                          head_dim=16, d_ff=256, vocab=512, remat="none")
