"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes that each piece of work needs, counted from its
shapes alone.

Frozen with the benchmark: a kernel or a step that does less work cannot
move its own yardstick.  The flash and paged counts are those of
``chip_smoke.py`` (its ``flash_times`` and ``paged_kernel``): QKᵀ and PV at
2 operations per multiply-add over the visible keys; q, k, v and the output
once; a decode row's K/V once, shared-prefix pages once.  A prefill is
charged the work it needs: a prompt's tokens whose K/V are already cached
(a fork's shared prefix) are keys, not queries.
"""
from __future__ import annotations

from typing import Dict, Iterable

# NVIDIA H100 SXM, data sheet, dense rates, at its full 700 W: HBM bytes
# per second and the bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
BF16_BYTES = 2


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes over the HBM rate or
    operations over the bf16 rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


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


def weight_bytes(cfg: Dict, itemsize: int = BF16_BYTES) -> int:
    """What a decode step reads of the weights: the matmul weights, the
    norms, once (the embedding rows it gathers are left out)."""
    norms = cfg["n_layers"] * 2 * cfg["d_model"] + cfg["d_model"]
    return (matmul_params(cfg) + norms) * itemsize


def causal_pairs(s: int) -> int:
    """Query-key pairs a causal sequence of ``s`` tokens scores."""
    return s * (s + 1) // 2


def attention_flops(cfg: Dict, s: int, cached: int = 0) -> int:
    """Causal attention forward of one sequence of ``s`` tokens over every
    layer, QKᵀ and PV, for the queries past its first ``cached``
    positions."""
    return cfg["n_layers"] * 4 * cfg["n_heads"] * cfg["head_dim"] \
        * (causal_pairs(s) - causal_pairs(cached))


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


def kv_bytes(cfg: Dict, tokens: int, itemsize: int = BF16_BYTES) -> int:
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


def flash_bound_s(b: int, s: int, h: int, hkv: int, d: int,
                  cached: int = 0, itemsize: int = BF16_BYTES) -> float:
    """One causal flash forward over ``s`` keys for the queries past the
    first ``cached`` (those whose K/V a prefill finds in the cache): q and
    the output of those queries once, k and v of all ``s`` once."""
    q = s - cached
    nbytes = itemsize * (2 * b * q * h * d + 2 * b * s * hkv * d)
    flops = 4 * d * b * h * (causal_pairs(s) - causal_pairs(cached))
    return bound_s(nbytes, flops)


def paged_bound_s(h: int, hkv: int, d: int, rows: int, keys: int,
                  longest: int, unique_tokens: int, page_tokens: int,
                  itemsize: int = BF16_BYTES) -> float:
    """One paged decode call of one layer over ``rows`` rows scoring
    ``keys`` keys in all, the longest row ``longest``: q and the output
    once, the K/V of ``unique_tokens`` tokens once, the page table and the
    lengths."""
    pp = -(-longest // page_tokens)
    nbytes = (unique_tokens * 2 * hkv * d * itemsize
              + 2 * rows * h * d * itemsize + 4 * rows * pp + 4 * rows)
    return bound_s(nbytes, 4 * d * h * keys)


def unique_kv_tokens(rows: Iterable[tuple], shared: Dict) -> int:
    """K/V tokens a decode step reads with each shared prefix once.
    ``rows``: (prefix key, length) of each row; ``shared``: the tokens of
    each prefix's full pages, which every row forked from it reads in
    place."""
    seen, total = set(), 0
    for key, length in rows:
        own = shared.get(key, 0)
        total += length - own
        if key not in seen:
            seen.add(key)
            total += own
    return total
