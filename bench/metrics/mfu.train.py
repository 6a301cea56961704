"""The train steps' share of the card's bf16 peak, in %: the model
operations of a step (6 per matmul weight per token, three causal attention
forwards per sequence, no recomputation) × the steps, over the summed step
spans (``next(pipeline)`` to the loss read back) × 989 TFLOP/s."""
from bench.harness import arith


def read(ctx):
    spans = ctx.get("spans", ())
    nxt = [s for s in spans if s[0] == "pipeline.next"]
    stp = [s for s in spans if s[0] == "train_step"]
    if not stp:
        return None
    secs = sum(b[2] - a[1] for a, b in zip(nxt, stp))
    flops = len(stp) * arith.train_flops(ctx["sizes"], ctx["batch"],
                                         ctx["seq_len"])
    return 100 * flops / (secs * arith.BF16_FLOPS)
