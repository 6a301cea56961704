"""The flash kernel's share of its roofline in the window's prefills, in %:
the least time of each launch (one per attention layer per prompt: the
queries past the shared prefix, whose K/V the fork finds cached, causal
over the whole prompt, from its shapes; the layers are the model family's)
summed, over the device time of ``flash_bf16`` in the trace."""
from bench.harness import arith


def read(ctx):
    trace = ctx.get("trace")
    adds = [s for s in ctx.get("spans", ()) if s[0] == "engine.add"]
    secs = trace.seconds(["flash_bf16"]) if trace is not None else None
    if not adds or not secs:
        return None
    least = sum(n * sum(arith.flash_bound_s(1, s, h, hkv, d, cached)
                        for *_, s, cached in adds)
                for n, h, hkv, d in
                ctx["family"].attention_layers(ctx["sizes"]))
    return 100 * least / secs
