"""The yardstick's arithmetic that depends on shapes alone: the card's
published peaks, and the operations and bytes of one flash or paged
launch.  What depends on the model (its layers, its weights) is its
family's (``bench/families/``).

Frozen with the benchmark: a kernel or a step that does less work cannot
move its own yardstick.  The flash and paged counts are those of
``chip_smoke.py`` (its ``flash_times`` and ``paged_kernel``): QKᵀ and PV at
2 operations per multiply-add over the visible keys; q, k, v and the output
once; a decode row's K/V once, shared-prefix pages once.
"""
from __future__ import annotations

from typing import Dict, Iterable

# NVIDIA H100 SXM, data sheet, rates without sparsity, at its full 700 W:
# HBM bytes per second and the bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
BF16_BYTES = 2


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes over the HBM rate or
    operations over the bf16 rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def causal_pairs(s: int) -> int:
    """Query-key pairs a causal sequence of ``s`` tokens scores."""
    return s * (s + 1) // 2


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
    place.  A row whose key ``shared`` lacks (``None``: no prefix) reads
    every token of its own."""
    seen, total = set(), 0
    for key, length in rows:
        own = shared.get(key, 0)
        total += length - own
        if key not in seen:
            seen.add(key)
            total += own
    return total
