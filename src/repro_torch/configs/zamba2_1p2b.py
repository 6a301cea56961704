"""zamba2-1.2b — hybrid: Mamba2 backbone + one weight-shared attention+MLP
block applied every 6 layers.  [arXiv:2411.15242; hf]

`long_context_window` makes the shared-attention sites sliding-window for
the long_500k cell (SSM state is O(1); only attention needs bounding).
"""
from .base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_kind="mamba2_hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    head_dim=64,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=64, head_dim=64, conv_width=4, expand=2,
                  chunk=128),
    hybrid=HybridConfig(attn_period=6, shared_attention=True),
    subquadratic=True,
    long_context_window=8192,
    remat="dots",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, remat="none",
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk=16),
        hybrid=HybridConfig(attn_period=2, shared_attention=True))
