"""Median milliseconds, over the window's decode steps, of the host's
preparation of a step before it dispatches the forward: the program's
``engine.step.prepare`` (tokens, positions, page allocation, copy-on-write,
the page table) and ``engine.step.upload`` (the three copies to the card)
spans.  The card is idle then: the step before ended on a read-back."""
from bench import program_spans as ps


def read(ctx):
    spans = ps.window(ctx)
    if not spans:
        return None
    kids = ps.children(spans)
    return ps.median_ms([
        sum(k.t1_ns - k.t0_ns for name in ("engine.step.prepare",
                                           "engine.step.upload")
            for k in kids[s.id][name])
        for s in ps.named(spans, "engine.step")])
