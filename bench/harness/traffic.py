"""The one traffic generator: every mix is a data file under
``bench/traffic/`` that this module reads.

Sizes and gaps are drawn by quantile, not at random: a mix of ``n``
requests takes the lognormal (or exponential) distribution's quantiles at
(i + 1/2) / n, clipped, in an order that the mix's own ``schedule_seed``
fixes; the run's seed draws the token ids.  So every seed offers the same
work in the same order, and runs with different seeds spread no wider
than runs of one seed would.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np

TRAFFIC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "traffic")


def load(name: str) -> Dict:
    with open(os.path.join(TRAFFIC_DIR, f"{name}.json")) as f:
        return json.load(f)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of the run's seed (any non-negative int)."""
    return np.random.default_rng([stream, seed])


def quantile_sizes(spec: Dict, n: int, rng: np.random.Generator
                   ) -> np.ndarray:
    """``n`` lengths from a lognormal of ``spec`` (median, sigma) at its
    quantiles, clipped to [min, max], in an order drawn from ``rng``."""
    nd = NormalDist()
    q = [(i + 0.5) / n for i in range(n)]
    x = np.array([spec["median"] * math.exp(spec["sigma"] * nd.inv_cdf(p))
                  for p in q])
    x = np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)
    return rng.permutation(x)


def shares(weights: List[float], n: int, rng: np.random.Generator
           ) -> np.ndarray:
    """``n`` picks among ``len(weights)`` choices in proportion to the
    weights (largest remainders), in an order drawn from ``rng``."""
    w = np.asarray(weights, float) / sum(weights)
    counts = np.floor(w * n).astype(int)
    rest = np.argsort(-(w * n - counts), kind="stable")[: n - counts.sum()]
    counts[rest] += 1
    return rng.permutation(np.repeat(np.arange(len(w)), counts))


def arrivals(rate: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """Offsets in seconds of ``n`` Poisson arrivals at ``rate`` per second:
    the exponential gaps' quantiles, shuffled; the first at 0."""
    gaps = np.array([-math.log(1 - (i + 0.5) / n) / rate for i in range(n)])
    gaps = rng.permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


@dataclass
class Request:
    prefix: Optional[int]        # index of the shared system prompt
    suffix: np.ndarray           # the request's own tokens (with no
                                 # prefix, the whole prompt)
    max_new: int                 # tokens to generate (greedy)
    due: float = 0.0             # offset from the window's start


@dataclass
class ServeMix:
    prefixes: List[np.ndarray]   # the shared system prompts
    requests: List[Request]      # the window's, in order
    warmup: List[Request]        # set-up's
    sample_tokens: int           # served tokens the check compares, at least


def serve_mix(mix: Dict, vocab: int, seed: int, seconds: float) -> ServeMix:
    """The requests of one serving run, open loop: ``rate_per_s`` ×
    (``warmup_s`` + ``seconds``) Poisson arrivals, the first ``warmup_s``'
    worth in set-up.  The arrivals, prefixes and sizes are drawn from the
    mix's ``schedule_seed``, the same for every run; the run's seed draws
    the token ids alone.  A mix with ``"prefixes": []`` shares no prompt:
    each request's prompt is its ``suffix`` alone, and its prefix None."""
    order = mix["schedule_seed"]
    rng = rng_for(seed, 0)
    prefixes = [rng.integers(0, vocab, p["tokens"]).astype(np.int32)
                for p in mix["prefixes"]]
    warm = int(round(mix["rate_per_s"] * mix["warmup_s"]))
    n = warm + max(1, int(round(mix["rate_per_s"] * seconds)))
    # offsets from the window's start, which falls when the first request
    # after the warm-up's is due
    due = arrivals(mix["rate_per_s"], n, rng_for(order, 1))
    due -= due[warm]
    which = [int(i) for i in shares([p["share"] for p in mix["prefixes"]],
                                    n, rng_for(order, 2))] \
        if prefixes else [None] * n
    suffix = quantile_sizes(mix["suffix"], n, rng_for(order, 3))
    out = quantile_sizes(mix["output"], n, rng_for(order, 4))
    toks = rng_for(seed, 5)
    reqs = [Request(which[i], toks.integers(0, vocab, int(suffix[i]))
                    .astype(np.int32), int(out[i]), float(due[i]))
            for i in range(n)]
    return ServeMix(prefixes, reqs[warm:], reqs[:warm], mix["sample_tokens"])


def corpus(vocab: int, records: int, block_tokens: int, seed: int
           ) -> np.ndarray:
    """The training corpus: ``records`` records of ``block_tokens`` token
    ids, uniform over the vocabulary."""
    return rng_for(seed, 6).integers(0, vocab, (records, block_tokens)
                                     ).astype(np.int32)


def sample(n: int, k: int, seed: int, always: Optional[int] = None
           ) -> List[int]:
    """``k`` of ``n`` indices drawn from the seed, with ``always`` among
    them."""
    order = [int(i) for i in rng_for(seed, 7).permutation(n)]
    if always is not None:
        order.remove(always)
        order.insert(0, always)
    return order[:k]
