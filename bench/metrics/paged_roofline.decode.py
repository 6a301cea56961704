"""The paged decode kernel's share of its roofline, in %: the least time of
each launch (one per attention layer per decode step: q and the output
once, the K/V of the tokens its rows read with a shared prefix once, the
table; the layers are the model family's) summed, over the device time of
``paged_fwd`` and ``paged_merge`` in the trace."""
from bench.harness import arith


def read(ctx):
    trace = ctx.get("trace")
    steps = ctx.get("steps", ())
    secs = trace.seconds(["paged_fwd", "paged_merge"]) \
        if trace is not None else None
    if not steps or not secs:
        return None
    least = sum(n * sum(arith.paged_bound_s(h, hkv, d, rows, keys, longest,
                                            unique, ctx["page_tokens"])
                        for _, _, rows, keys, longest, unique in steps)
                for n, h, hkv, d in
                ctx["family"].attention_layers(ctx["sizes"]))
    return 100 * least / secs
