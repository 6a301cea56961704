"""Median milliseconds, over the window's decode steps, of the card's idle
time inside a step's device work: from the first to the last device
operation (in the profiler's trace) that starts between the step's
``engine.step.forward`` start and its ``engine.step.sync`` end (the
program's spans, on the profiler's clock), the time no operation ran."""
import bisect

from bench import program_spans as ps


def read(ctx):
    spans = ps.window(ctx)
    trace = ctx.get("trace")
    if not spans or not trace.ops:
        return None
    off = ctx["epoch_offset_ns"]
    starts = [s for _, s, _ in trace.ops]
    kids = ps.children(spans)
    gaps = []
    for step in ps.named(spans, "engine.step"):
        fwd, sync = (kids[step.id]["engine.step.forward"],
                     kids[step.id]["engine.step.sync"])
        if not fwd or not sync:
            continue
        lo = bisect.bisect_left(starts, fwd[0].t0_ns + off)
        hi = bisect.bisect_left(starts, sync[0].t1_ns + off)
        if lo == hi:
            continue
        idle, reach = 0, trace.ops[lo][1]
        for _, s, d in trace.ops[lo:hi]:
            idle += max(0, s - reach)
            reach = max(reach, s + d)
        gaps.append(idle)
    return ps.median_ms(gaps)
