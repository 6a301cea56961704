"""mistral-large-123b — dense GQA transformer.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    arch_kind="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    head_dim=128,
    rope_theta=1e6,
    # remat="dots" was tried (§Perf B4): collective −14% but saved dot
    # outputs blow the live set to 1.29 TB/device — "full" + 16-way
    # gradient accumulation is the config that fits HBM
    remat="full",
    accum_steps=16,
    # kv=8 does not divide the 16-way model axis → K/V replicated under TP
    rules_overrides=(("kv_heads", None),),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                          head_dim=16, d_ff=256, vocab=512, remat="none",
                          accum_steps=1)
