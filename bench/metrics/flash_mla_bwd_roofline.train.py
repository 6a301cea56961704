"""The flash backward kernel's share of its roofline at latent
attention's head sizes (Q and K 192, V 128) in the train steps, in %: the
least time of every backward launch (one per layer per microbatch,
causal, from its shapes: the model family's ``flash_launches`` and
``flash_bwd_counts``, 2 · pairs · (3·192 + 2·128) operations a head, q,
dq, k and dk at 192, out, dout, v and dv at 128 once) summed, over the
device time of the (192, 128) backward's three kernels (``flash_bwd``,
its pre-pass ``flash_bwd_prep`` and its post-pass ``flash_bwd_dq``)."""
from bench.harness import arith

KERNELS = ["flash_bwd<192", "flash_bwd_prep<192", "flash_bwd_dq<192"]


def read(ctx):
    trace = ctx.get("trace")
    secs = trace.seconds(KERNELS) if trace is not None else None
    fam = ctx.get("family")
    if not ctx.get("steps") or not secs or \
            not hasattr(fam, "flash_bwd_counts"):
        return None
    k = ctx["accum_steps"]
    least = sum(ctx["steps"] * k * n * arith.bound_s(*reversed(
        fam.flash_bwd_counts(ctx["batch"] // k, ctx["seq_len"], h, hkv, dk,
                             dv)))
        for n, h, hkv, dk, dv in fam.flash_launches(ctx["sizes"]))
    return 100 * least / secs
