"""The flash kernel's share of its roofline in the train steps' forwards,
in %: the least time of each launch (one per attention layer per
microbatch, causal, from its shapes; the layers are the model family's)
summed, over the device time of ``flash_bf16`` in the trace.  The
attention backward, the ``flash_bwd`` kernels, is
``flash_bwd_roofline.train``'s."""
from bench.harness import arith


def read(ctx):
    trace = ctx.get("trace")
    secs = trace.seconds(["flash_bf16"]) if trace is not None else None
    if not ctx.get("steps") or not secs:
        return None
    k = ctx["accum_steps"]
    least = sum(ctx["steps"] * k * n * arith.flash_bound_s(
        ctx["batch"] // k, ctx["seq_len"], h, hkv, d)
        for n, h, hkv, d in ctx["family"].attention_layers(ctx["sizes"]))
    return 100 * least / secs
