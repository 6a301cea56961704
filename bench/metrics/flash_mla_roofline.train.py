"""The flash kernel's share of its roofline at latent attention's head
sizes (Q and K 192, V 128) in the train steps' forwards, in %: the least
time of each launch (one per layer per microbatch, causal, from its
shapes: the model family's ``flash_launches`` and ``flash_fwd_counts``,
2 · pairs · (192 + 128) operations a head, q and k at 192 and v and the
output at 128 once) summed, over the device time of the (192, 128)
forward kernel, ``flash_bf16<192, 128>``, in the trace."""
from bench.harness import arith

KERNELS = ["flash_bf16<192"]


def read(ctx):
    trace = ctx.get("trace")
    secs = trace.seconds(KERNELS) if trace is not None else None
    fam = ctx.get("family")
    if not ctx.get("steps") or not secs or \
            not hasattr(fam, "flash_fwd_counts"):
        return None
    k = ctx["accum_steps"]
    least = sum(ctx["steps"] * k * n * arith.bound_s(*reversed(
        fam.flash_fwd_counts(ctx["batch"] // k, ctx["seq_len"], h, hkv, dk,
                             dv)))
        for n, h, hkv, dk, dv in fam.flash_launches(ctx["sizes"]))
    return 100 * least / secs
