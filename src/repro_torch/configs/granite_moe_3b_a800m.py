"""granite-moe-3b-a800m — MoE, 40 experts top-8 (following the explicit
`MoE 40e top-8` spec; the source-bracket note says 32 — recorded in
DESIGN.md §Arch-applicability).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_kind="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    tie_embeddings=True,
    # 40 experts do not divide the 16-way model axis: pad the expert
    # dimension to 48 (dead experts get no routing weight, no tokens) so
    # EP shards 16-way — §Perf hillclimb iteration on this cell
    moe=MoEConfig(num_experts=40, top_k=8, d_expert=512,
                  padded_experts=48),
    remat="none",
    # 24 heads / 8 kv do not divide the 16-way model axis; the expert
    # hidden dim must stay unsharded once "experts" maps to model
    rules_overrides=(("heads", None), ("kv_heads", None), ("mlp", None)),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab=512,
                          moe=MoEConfig(num_experts=8, top_k=2,
                                        d_expert=64))
