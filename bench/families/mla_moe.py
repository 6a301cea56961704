"""The DeepSeek-V3 family (Moonlight-16B-A3B): multi-head latent attention
(no query LoRA), a leading dense SwiGLU layer, then layers of sigmoid-
routed experts with shared experts, of which this chip holds a share.

What the harness takes by the configuration's ``"family": "mla_moe"``:
the sizes, the stacked parameter tree, the port's model config, and the
operations and bytes of the training step and of each flash launch at
its two head sizes (Q and K of nope + rope dims, V and the output of
``v_dim``), counted from the shapes alone.  The configuration states the
chip's share: ``n_routed_experts`` experts held, from ``experts_first``,
of the router's ``router_experts``.  No serving: the port has no latent
cache.
"""
from __future__ import annotations

from typing import Dict, List

from bench.harness import arith

# the published config's keys → the model's sizes as the harness and the
# reference name them
KEYS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
        "moe_intermediate_size": "d_expert",
        "num_hidden_layers": "n_layers", "num_attention_heads": "n_heads",
        "kv_lora_rank": "kv_rank", "qk_nope_head_dim": "qk_nope",
        "qk_rope_head_dim": "qk_rope", "v_head_dim": "v_dim",
        "num_experts_per_tok": "top_k", "router_experts": "n_experts",
        "n_routed_experts": "held", "experts_first": "held_first",
        "first_k_dense_replace": "first_k_dense",
        "routed_scaling_factor": "routed_scale", "vocab_size": "vocab",
        "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
        "kv_norm_eps": "kv_norm_eps", "aux_loss_alpha": "aux_alpha",
        "capacity_factor": "capacity_factor",
        "tie_word_embeddings": "tie_embeddings"}

# the configuration section's keys that the port's ModelConfig takes
PROGRAM_KEYS = ("param_dtype", "compute_dtype", "attn_impl", "remat")


def sizes(config: Dict) -> Dict:
    """The model's sizes under the harness's names; ``d_shared`` is the
    shared experts' total width, ``microbatch_rows`` the rows over which
    the training section's step counts its experts' capacity."""
    m = {ours: config[theirs] for theirs, ours in KEYS.items()}
    m["d_shared"] = config["n_shared_experts"] * config["moe_intermediate_size"]
    m["microbatch_rows"] = config["training"]["microbatch_rows"]
    if not 0 <= m["held_first"] <= m["n_experts"] - m["held"]:
        raise ValueError(f"bench: experts [{m['held_first']}, "
                         f"{m['held_first'] + m['held']}) held of "
                         f"{m['n_experts']}")
    return m


def _attention(prefix: str, n: int, m: Dict) -> Dict[str, tuple]:
    d, h = m["d_model"], m["n_heads"]
    qk = m["qk_nope"] + m["qk_rope"]
    return {
        f"{prefix}ln": ((n, d), "norm"),
        f"{prefix}wq": ((n, d, h * qk), "fan_in"),
        f"{prefix}wkva": ((n, d, m["kv_rank"] + m["qk_rope"]), "fan_in"),
        f"{prefix}kv_ln": ((n, m["kv_rank"]), "norm"),
        f"{prefix}wkvb": ((n, m["kv_rank"], h * (m["qk_nope"] + m["v_dim"])),
                          "fan_in"),
        f"{prefix}wo": ((n, h * m["v_dim"], d), "fan_in"),
        f"{prefix}ln2": ((n, d), "norm"),
    }


def shapes(m: Dict) -> Dict[str, tuple]:
    """Every leaf of the parameter tree: its shape, and how it is drawn.
    The leading dense layers are ``dense_<leaf>`` [first_k_dense, ...] at
    the top of the tree, the expert layers ``layers/<leaf>``.  The
    correction bias is drawn as a norm scale is, 1 + 0.1·N(0, 1): a spread
    of 0.1 beside the scores' (the constant selects nothing), fixed by the
    seed, never trained."""
    d, k, ff = m["d_model"], m["first_k_dense"], m["d_ff"]
    n = m["n_layers"] - k
    e, de, ds = m["held"], m["d_expert"], m["d_shared"]
    out = {"embedding": ((m["vocab"], d), "embed"),
           "ln_f": ((d,), "norm")}
    out.update(_attention("dense_", k, m))
    out.update({"dense_w_gate": ((k, d, ff), "fan_in"),
                "dense_w_up": ((k, d, ff), "fan_in"),
                "dense_w_down": ((k, ff, d), "fan_in")})
    out.update(_attention("layers/", n, m))
    out.update({
        "layers/router": ((n, d, m["n_experts"]), "fan_in"),
        "layers/router_bias": ((n, m["n_experts"]), "norm"),
        "layers/w_gate": ((n, e, d, de), "fan_in"),
        "layers/w_up": ((n, e, d, de), "fan_in"),
        "layers/w_down": ((n, e, de, d), "fan_in"),
        "layers/shared_gate": ((n, d, ds), "fan_in"),
        "layers/shared_up": ((n, d, ds), "fan_in"),
        "layers/shared_down": ((n, ds, d), "fan_in"),
    })
    if not m["tie_embeddings"]:
        out["unembedding"] = ((m["vocab"], d), "embed")
    return out


def program_config(config: Dict, m: Dict, section: str, **extra):
    """The port's ``MLAModelConfig`` of this model as the configuration's
    ``section`` (``training``) runs it; ``extra``: fields that the
    traffic sets (``accum_steps``)."""
    from repro_torch.configs.base import (DeepSeekMoEConfig, MLAConfig,
                                          MLAModelConfig)
    s = config[section]
    return MLAModelConfig(
        name=config["name"], arch_kind="mla_moe", n_layers=m["n_layers"],
        d_model=m["d_model"], n_heads=m["n_heads"],
        n_kv_heads=m["n_heads"], d_ff=m["d_ff"], vocab=m["vocab"],
        tie_embeddings=m["tie_embeddings"], rope_theta=m["rope_theta"],
        norm_eps=m["norm_eps"], first_k_dense=m["first_k_dense"],
        mla=MLAConfig(kv_rank=m["kv_rank"], qk_nope=m["qk_nope"],
                      qk_rope=m["qk_rope"], v_dim=m["v_dim"],
                      kv_norm_eps=m["kv_norm_eps"]),
        moe=DeepSeekMoEConfig(
            num_experts=m["n_experts"], top_k=m["top_k"],
            d_expert=m["d_expert"], capacity_factor=m["capacity_factor"],
            router_aux_weight=m["aux_alpha"],
            routed_scale=m["routed_scale"], d_shared=m["d_shared"],
            held_first=m["held_first"], held=m["held"]),
        **{k: s[k] for k in PROGRAM_KEYS if k in s}, **extra)


def qk_dim(m: Dict) -> int:
    return m["qk_nope"] + m["qk_rope"]


def attention_matmul_params(m: Dict) -> int:
    """Weights of one latent attention that a token multiplies: W_q,
    W_kva, W_kvb, W_o."""
    d, h = m["d_model"], m["n_heads"]
    return (d * h * qk_dim(m) + d * (m["kv_rank"] + m["qk_rope"])
            + m["kv_rank"] * h * (m["qk_nope"] + m["v_dim"])
            + h * m["v_dim"] * d)


def dense_matmul_params(m: Dict) -> int:
    """Every token's weights outside the routed experts: each layer's
    attention, the dense layers' SwiGLU, each expert layer's router and
    shared experts, and the output head."""
    d = m["d_model"]
    n_moe = m["n_layers"] - m["first_k_dense"]
    return (m["n_layers"] * attention_matmul_params(m)
            + m["first_k_dense"] * 3 * d * m["d_ff"]
            + n_moe * (d * m["n_experts"] + 3 * d * m["d_shared"])
            + m["vocab"] * d)


def routed_flops(m: Dict, choices: float) -> float:
    """Forward and backward of ``choices`` routed choices computed by the
    experts held: 6 per weight of one expert's SwiGLU."""
    return 6 * 3 * m["d_model"] * m["d_expert"] * choices


def held_choices(m: Dict, tokens: int) -> float:
    """The choices that reach the held experts, every layer, if the router
    spread them evenly and nothing were dropped."""
    return (m["n_layers"] - m["first_k_dense"]) * tokens * m["top_k"] \
        * m["held"] / m["n_experts"]


def attention_flops(m: Dict, s: int) -> int:
    """Causal latent attention forward of one sequence of ``s`` tokens
    over every layer: QKᵀ over nope + rope dims and PV over ``v_dim``."""
    return m["n_layers"] * 2 * m["n_heads"] * arith.causal_pairs(s) \
        * (qk_dim(m) + m["v_dim"])


def train_flops(m: Dict, batch: int, s: int, routed_choices=None) -> float:
    """One train step's model operations: 6 per weight a token multiplies
    outside the routed experts, ``routed_flops`` of the routed choices
    computed (``routed_choices``; None: `held_choices`), and three causal
    attention forwards per sequence; recomputation is not counted."""
    if routed_choices is None:
        routed_choices = held_choices(m, batch * s)
    return 6 * dense_matmul_params(m) * batch * s \
        + routed_flops(m, routed_choices) + 3 * batch * attention_flops(m, s)


def flash_launches(m: Dict) -> List[tuple]:
    """The flash launches of one pass through the model: (layers, query
    heads, K/V heads, Q/K head size, V head size) each."""
    return [(m["n_layers"], m["n_heads"], m["n_heads"], qk_dim(m),
             m["v_dim"])]


def flash_fwd_counts(b: int, s: int, h: int, hkv: int, dk: int, dv: int,
                     itemsize: int = arith.BF16_BYTES) -> tuple:
    """(operations, bytes) of one causal flash forward: QKᵀ and PV, 2·(dk +
    dv) per visible pair and head; q and k at dk, v and the output at dv,
    once."""
    flops = 2 * b * h * arith.causal_pairs(s) * (dk + dv)
    nbytes = itemsize * b * s * (h * dk + hkv * dk + hkv * dv + h * dv)
    return flops, nbytes


def flash_bwd_counts(b: int, s: int, h: int, hkv: int, dk: int, dv: int,
                     itemsize: int = arith.BF16_BYTES) -> tuple:
    """(operations, bytes) of one causal flash backward: QKᵀ, dO·Vᵀ, Pᵀ·dO,
    dSᵀ·Q and dS·K, 2·(3·dk + 2·dv) per visible pair and head; q, dq, k and
    dk at dk, out, dout, v and dv at dv, once."""
    flops = 2 * b * h * arith.causal_pairs(s) * (3 * dk + 2 * dv)
    nbytes = itemsize * b * s * (2 * h * (dk + dv) + 2 * hkv * (dk + dv))
    return flops, nbytes
