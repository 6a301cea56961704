"""The prefills' share of the card's bf16 peak, in %: the model
operations that every prompt admitted in the window needs (its tokens past
the shared prefix, whose K/V the fork finds cached, through the matmul
weights; their causal attention over the whole prompt; the last position's
output head; the model family's count) over the summed time of the
``Engine.add`` spans × 989 TFLOP/s."""
from bench.harness import arith


def read(ctx):
    adds = [s for s in ctx.get("spans", ()) if s[0] == "engine.add"]
    if not adds:
        return None
    flops = sum(ctx["family"].prefill_flops(ctx["sizes"], n, cached)
                for *_, n, cached in adds)
    secs = sum(t1 - t0 for _, t0, t1, *_ in adds)
    return 100 * flops / (secs * arith.BF16_FLOPS)
