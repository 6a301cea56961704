"""The train steps' share of the card's bf16 peak, in %, with the routed
experts' work as the program did it: the model operations of the window's
steps (the model family's ``train_flops`` with no routed choice, 6 per
weight a token multiplies outside the routed experts and three causal
attention forwards per sequence) and of every routed choice the held
experts computed, Σ (``held_choices`` − ``dropped_choices``) over the
program's ``moe.route`` spans in the window (``routed_flops``), over the
time from the window's open to the last step's end on the card × 989
TFLOP/s.  A program without those counts reads nothing."""
from bench import program_spans as ps
from bench.harness import arith


def read(ctx):
    ends = ctx.get("step_ends") or []
    spans = ps.window(ctx)
    if not ends or not spans:
        return None
    routes = [s for s in ps.named(spans, "moe.route")
              if "held_choices" in s.counts]
    if not routes:
        return None
    fam, m = ctx["family"], ctx["sizes"]
    done = sum(int(s.counts["held_choices"]) - int(s.counts["dropped_choices"])
               for s in routes)
    flops = len(ends) * fam.train_flops(m, ctx["batch"], ctx["seq_len"],
                                        routed_choices=0) \
        + fam.routed_flops(m, done)
    secs = ends[-1] - ctx["window_start"]
    return 100 * flops / (secs * arith.BF16_FLOPS)
