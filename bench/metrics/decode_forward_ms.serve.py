"""Median milliseconds, over the window's decode steps, of the forward's
time on the card's stream: CUDA events the program records at the start
and the end of its ``engine.step.forward`` span (the layer loop's
dispatch).  It is wall time on the stream, the launch gaps inside it
included: where the host's dispatch falls behind the card, the dispatch
sets it.  Less ``decode_launch_gap_ms.serve``, it is the card's work."""
from bench import program_spans as ps


def read(ctx):
    spans = ps.window(ctx)
    if not spans:
        return None
    return ps.median_ms([s.device_ns for s in
                         ps.named(spans, "engine.step.forward")])
