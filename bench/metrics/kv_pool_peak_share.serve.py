"""The largest share of the KV page pool in use at the end of a decode step
in the window, in %: the program's ``engine.step`` counts
``pages_in_use`` (pages held by a sequence, the engine's scratch page
with them) over ``pool_pages``."""
from bench import program_spans as ps


def read(ctx):
    spans = ps.window(ctx)
    steps = ps.named(spans, "engine.step") if spans else []
    if not steps:
        return None
    return max(100 * s.counts["pages_in_use"] / s.counts["pool_pages"]
               for s in steps)
