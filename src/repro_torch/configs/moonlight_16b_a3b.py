"""moonlight-16b-a3b — DeepSeek-V3 block: latent attention, 64 sigmoid-
routed experts top-6 with 2 shared, one leading dense layer.
[hf moonshotai/Moonlight-16B-A3B config.json]  A family of the port alone:
the JAX package has no such block."""
from .base import DeepSeekMoEConfig, MLAConfig, MLAModelConfig

CONFIG = MLAModelConfig(
    name="moonlight-16b-a3b",
    arch_kind="mla_moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,                     # the leading dense layer's SwiGLU
    vocab=163840,
    rope_theta=50000.0,
    norm_eps=1e-5,
    mla=MLAConfig(kv_rank=512, qk_nope=128, qk_rope=64, v_dim=128),
    first_k_dense=1,
    # the balance loss's α is DeepSeek-V3's 1e-4 (the config gives none);
    # n_group = topk_group = 1: group-limited routing is the identity
    moe=DeepSeekMoEConfig(num_experts=64, top_k=6, d_expert=1408,
                          router_aux_weight=1e-4, routed_scale=2.446,
                          d_shared=2 * 1408),
    attn_impl="pallas",
)


def smoke() -> MLAModelConfig:
    """Every width cut, the structure kept: latent, rotary and value dims
    of unequal sizes, a leading dense layer, shared experts, a top-k of
    the router's experts."""
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab=512,
        mla=MLAConfig(kv_rank=32, qk_nope=16, qk_rope=8, v_dim=16),
        moe=DeepSeekMoEConfig(num_experts=8, top_k=2, d_expert=32,
                              router_aux_weight=1e-4, routed_scale=2.446,
                              d_shared=64),
        attn_impl="xla")
