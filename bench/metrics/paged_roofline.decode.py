"""The paged decode kernel's share of its roofline, in %: the least time of
each launch (one per layer per decode step: q and the output once, the K/V
of the tokens its rows read with a shared prefix once, the table) summed,
over the device time of ``paged_fwd`` and ``paged_merge`` in the trace."""
from bench.harness import arith


def read(ctx):
    trace = ctx.get("trace")
    steps = ctx.get("steps", ())
    secs = trace.seconds(["paged_fwd", "paged_merge"]) \
        if trace is not None else None
    if not steps or not secs:
        return None
    m = ctx["sizes"]
    least = m["n_layers"] * sum(
        arith.paged_bound_s(m["n_heads"], m["n_kv_heads"], m["head_dim"],
                            rows, keys, longest, unique, ctx["page_tokens"])
        for _, _, rows, keys, longest, unique in steps)
    return 100 * least / secs
