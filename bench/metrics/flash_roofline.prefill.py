"""The flash kernel's share of its roofline in the window's prefills, in %:
the least time of each launch (one per layer per prompt: the queries past
the shared prefix, whose K/V the fork finds cached, causal over the whole
prompt, from its shapes) summed, over the device time of ``flash_bf16`` in
the trace."""
from bench.harness import arith


def read(ctx):
    trace = ctx.get("trace")
    adds = [s for s in ctx.get("spans", ()) if s[0] == "engine.add"]
    secs = trace.seconds(["flash_bf16"]) if trace is not None else None
    if not adds or not secs:
        return None
    m = ctx["sizes"]
    least = m["n_layers"] * sum(
        arith.flash_bound_s(1, n, m["n_heads"], m["n_kv_heads"],
                            m["head_dim"], cached)
        for *_, n, cached in adds)
    return 100 * least / secs
