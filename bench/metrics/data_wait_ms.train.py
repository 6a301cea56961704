"""Median milliseconds a train step waits for its batch: ``next(pipeline)``
and the batch's host-to-device copy (the benchmark's spans)."""
import statistics


def read(ctx):
    waits = [t1 - t0 for name, t0, t1, *_ in ctx.get("spans", ())
             if name == "pipeline.next"]
    return statistics.median(waits) * 1e3 if waits else None
