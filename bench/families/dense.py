"""The dense decoder family (smollm, mistral-large): pre-norm blocks of
grouped-query attention and a SwiGLU MLP, every layer alike.

What the harness takes by the configuration's ``"family": "dense"``: the
sizes, the stacked parameter tree, the port's model config, and the
operations and bytes of each piece of work, counted from the shapes alone.
The counts are those of ``chip_smoke.py`` (its ``flash_times`` and
``paged_kernel``); ``bench/harness/arith.py`` holds what depends on the
shapes of one launch alone.  A prefill is charged the work it needs: a
prompt's tokens whose K/V are already cached (a fork's shared prefix) are
keys, not queries.
"""
from __future__ import annotations

from typing import Dict, List

from bench.harness import arith

# the published config's keys → the model's sizes as the harness and the
# reference name them
KEYS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
        "num_hidden_layers": "n_layers", "num_attention_heads": "n_heads",
        "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
        "vocab_size": "vocab", "rope_theta": "rope_theta",
        "rms_norm_eps": "norm_eps", "tie_word_embeddings": "tie_embeddings"}

# the configuration section's keys that the port's ModelConfig takes
PROGRAM_KEYS = ("param_dtype", "compute_dtype", "attn_impl", "remat")


def sizes(config: Dict) -> Dict:
    """The model's sizes under the harness's names."""
    return {ours: config[theirs] for theirs, ours in KEYS.items()}


def shapes(m: Dict) -> Dict[str, tuple]:
    """Every leaf of the dense model's stacked parameter tree: its shape,
    and how it is drawn (fan-in scaled normal, embedding normal, or a norm
    scale near 1)."""
    d, hd, n = m["d_model"], m["head_dim"], m["n_layers"]
    out = {
        "embedding": ((m["vocab"], d), "embed"),
        "ln_f": ((d,), "norm"),
        "layers/ln": ((n, d), "norm"),
        "layers/ln2": ((n, d), "norm"),
        "layers/wq": ((n, d, m["n_heads"] * hd), "fan_in"),
        "layers/wk": ((n, d, m["n_kv_heads"] * hd), "fan_in"),
        "layers/wv": ((n, d, m["n_kv_heads"] * hd), "fan_in"),
        "layers/wo": ((n, m["n_heads"] * hd, d), "fan_in"),
        "layers/w_gate": ((n, d, m["d_ff"]), "fan_in"),
        "layers/w_up": ((n, d, m["d_ff"]), "fan_in"),
        "layers/w_down": ((n, m["d_ff"], d), "fan_in"),
    }
    if not m["tie_embeddings"]:
        out["unembedding"] = ((m["vocab"], d), "embed")
    return out


def program_config(config: Dict, m: Dict, section: str, **extra):
    """The port's ``ModelConfig`` of this model as the configuration's
    ``section`` (``serving`` or ``training``) runs it; ``extra``: fields
    that the traffic sets (``accum_steps``)."""
    from repro_torch.configs.base import ModelConfig
    s = config[section]
    return ModelConfig(name=config["name"], arch_kind="dense",
                       **{k: s[k] for k in PROGRAM_KEYS if k in s},
                       **extra, **m)


def layer_matmul_params(cfg: Dict) -> int:
    """Weights of one dense block that a token multiplies: q, k, v, o and
    the SwiGLU's gate, up and down."""
    d, h, hkv, hd, ff = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                         cfg["head_dim"], cfg["d_ff"])
    return d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * ff


def matmul_params(cfg: Dict) -> int:
    """Every layer's matmul weights and the output head."""
    return cfg["n_layers"] * layer_matmul_params(cfg) \
        + cfg["vocab"] * cfg["d_model"]


def weight_bytes(cfg: Dict, itemsize: int = arith.BF16_BYTES) -> int:
    """What a decode step reads of the weights: the matmul weights, the
    norms, once (the embedding rows it gathers are left out)."""
    norms = cfg["n_layers"] * 2 * cfg["d_model"] + cfg["d_model"]
    return (matmul_params(cfg) + norms) * itemsize


def attention_flops(cfg: Dict, s: int, cached: int = 0) -> int:
    """Causal attention forward of one sequence of ``s`` tokens over every
    layer, QKᵀ and PV, for the queries past its first ``cached``
    positions."""
    return cfg["n_layers"] * 4 * cfg["n_heads"] * cfg["head_dim"] \
        * (arith.causal_pairs(s) - arith.causal_pairs(cached))


def prefill_flops(cfg: Dict, s: int, cached: int = 0) -> int:
    """A prompt of ``s`` tokens whose first ``cached`` already have their
    K/V in the cache (a fork's shared prefix, whose open page the fork
    copies): the other ``s - cached`` tokens through every layer, their
    attention over the whole prompt, and the output head for the last
    position.  The work a prefill needs, whatever it recomputes."""
    return 2 * cfg["n_layers"] * layer_matmul_params(cfg) * (s - cached) \
        + 2 * cfg["vocab"] * cfg["d_model"] + attention_flops(cfg, s, cached)


def decode_flops(cfg: Dict, rows: int, keys: int) -> int:
    """One decode step of ``rows`` rows: each row's token through the
    weights, and ``keys`` keys in all scored in every layer."""
    per_key = cfg["n_layers"] * 4 * cfg["n_heads"] * cfg["head_dim"]
    return 2 * matmul_params(cfg) * rows + per_key * keys


def kv_bytes(cfg: Dict, tokens: int, itemsize: int = arith.BF16_BYTES
             ) -> int:
    """K and V of ``tokens`` tokens in every layer."""
    return cfg["n_layers"] * 2 * cfg["n_kv_heads"] * cfg["head_dim"] \
        * tokens * itemsize


def decode_bytes(cfg: Dict, unique_tokens: int) -> int:
    """One decode step: the weights once, and the K/V of the tokens it
    reads, a shared prefix once."""
    return weight_bytes(cfg) + kv_bytes(cfg, unique_tokens)


def train_flops(cfg: Dict, batch: int, s: int) -> int:
    """One train step's model operations: 6 per matmul weight per token
    (forward and backward) and three causal attention forwards per
    sequence; recomputation is not counted."""
    return 6 * matmul_params(cfg) * batch * s \
        + 3 * batch * attention_flops(cfg, s)


def attention_layers(cfg: Dict) -> List[tuple]:
    """The attention launches of one pass through the model, by kind of
    layer: (layers, query heads, K/V heads, head size) each.  Every dense
    layer is alike; the readers charge each layer one launch's least time
    (``arith.flash_bound_s``, ``arith.paged_bound_s``)."""
    return [(cfg["n_layers"], cfg["n_heads"], cfg["n_kv_heads"],
             cfg["head_dim"])]
