"""Median milliseconds of one train step: from ``next(pipeline)`` to the
loss read back after ``train_step`` (the benchmark's spans)."""
import statistics


def read(ctx):
    spans = ctx.get("spans", ())
    nxt = [s for s in spans if s[0] == "pipeline.next"]
    stp = [s for s in spans if s[0] == "train_step"]
    steps = [b[2] - a[1] for a, b in zip(nxt, stp)]
    return statistics.median(steps) * 1e3 if steps else None
