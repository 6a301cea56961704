"""xlstm-1.3b — sLSTM + mLSTM blocks (7 mLSTM : 1 sLSTM).
[arXiv:2405.04517; unverified]

Fully recurrent (no attention): long_500k runs with O(1) state.
"""
from .base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_kind="xlstm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                         # FFN lives inside the blocks
    vocab=50304,
    xlstm=XLSTMConfig(slstm_every=8, qk_dim_factor=0.5, v_dim_factor=1.0,
                      chunk=128),
    subquadratic=True,
    remat="dots",
    rules_overrides=(("heads", None),),   # 4 heads < 16-way model axis
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
                          vocab=512, remat="none",
                          xlstm=XLSTMConfig(slstm_every=2, chunk=16))
