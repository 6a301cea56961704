"""The share of the traced window in which no operation ran on the card,
in %: 1 - busy / wall, busy being the union of the device operations'
intervals in the profiler's trace."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.ops:
        return None
    return 100 * (1 - trace.busy_s() / trace.window_s)
