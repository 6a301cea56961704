"""Median milliseconds of one train step: the time between the ends of
consecutive steps on the card (an event after each step, the first from
the window's open).  The window sends steps ahead, so this is the card's
pace; a host stall shows only where the queue ran dry."""
import statistics


def read(ctx):
    ends = ctx.get("step_ends") or []
    steps = [b - a for a, b in zip([ctx.get("window_start")] + ends, ends)]
    return statistics.median(steps) * 1e3 if steps else None
