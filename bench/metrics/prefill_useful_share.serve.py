"""The share of the prefills' work that was needed, in %: over the
window's ``engine.add`` spans, the prompt tokens less those of the fork's
shared prefix, whose K/V the engine already holds (counts
``prompt_tokens``, ``cached_tokens``), over the tokens the prefill ran
through the forward (``computed_tokens``).  A prefill that recomputes the
prefix reads the suffix's share; one that runs the suffix alone, 100 %."""
from bench import program_spans as ps


def read(ctx):
    spans = ps.window(ctx)
    adds = ps.named(spans, "engine.add") if spans else []
    computed = sum(s.counts["computed_tokens"] for s in adds)
    if not computed:
        return None
    return 100 * sum(s.counts["prompt_tokens"] - s.counts["cached_tokens"]
                     for s in adds) / computed
