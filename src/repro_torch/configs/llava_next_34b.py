"""llava-next-34b — VLM: dense GQA backbone + anyres patch-embedding stub.
The vision tower is a stub per the assignment: input_specs() provides
precomputed patch embeddings [B, num_patches, vision_dim].
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from .base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    arch_kind="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
    rope_theta=5e6,
    vlm=VLMConfig(num_patches=576, vision_dim=1024),
    remat="full",
    rules_overrides=(("heads", None), ("kv_heads", None)),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                          head_dim=16, d_ff=256, vocab=512, remat="none",
                          vlm=VLMConfig(num_patches=8, vision_dim=32))
