"""smollm-360m — llama-architecture small dense GQA.
[hf:HuggingFaceTB/SmolLM-135M; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    arch_kind="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
    head_dim=64,
    tie_embeddings=True,
    remat="none",
    rules_overrides=(("heads", None), ("kv_heads", None)),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=96, n_heads=3, n_kv_heads=1,
                          head_dim=32, d_ff=192, vocab=512)
