"""qwen2-7b — dense GQA with QKV biases.  [arXiv:2407.10671; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    arch_kind="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    remat="dots",
    # 28 heads / 4 kv heads do not divide the 16-way model axis
    rules_overrides=(("heads", None), ("kv_heads", None)),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          head_dim=32, d_ff=256, vocab=512, remat="none")
