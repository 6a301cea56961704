"""The train steps' share of the card's bf16 peak, in %: the model
operations of a step (6 per matmul weight per token, three causal attention
forwards per sequence, no recomputation: the model family's count) × the
steps, over the time from the window's open to the last step's end on the
card × 989 TFLOP/s."""
from bench.harness import arith


def read(ctx):
    ends = ctx.get("step_ends") or []
    if not ends:
        return None
    secs = ends[-1] - ctx["window_start"]
    flops = len(ends) * ctx["family"].train_flops(
        ctx["sizes"], ctx["batch"], ctx["seq_len"])
    return 100 * flops / (secs * arith.BF16_FLOPS)
