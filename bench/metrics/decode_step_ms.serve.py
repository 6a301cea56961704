"""Median milliseconds of ``Engine.step``: the benchmark's spans around
each decode step (it waits for the tokens on the host)."""
import statistics


def read(ctx):
    steps = [t1 - t0 for name, t0, t1, *_ in ctx.get("spans", ())
             if name == "engine.step"]
    return statistics.median(steps) * 1e3 if steps else None
