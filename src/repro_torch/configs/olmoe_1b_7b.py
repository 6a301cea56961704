"""olmoe-1b-7b — MoE, 64 experts top-8.  [arXiv:2409.02060; hf]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    arch_kind="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024),
    remat="dots",
    # EP: experts shard 16-way on "model"; the expert hidden dim must then
    # stay unsharded (a spec may not map one mesh axis twice)
    rules_overrides=(("mlp", None),),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=16, d_ff=128, vocab=512, remat="none",
                          moe=MoEConfig(num_experts=8, top_k=2,
                                        d_expert=128))
