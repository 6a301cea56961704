"""The flash kernel's share of its roofline in the train steps' forwards,
in %: the least time of each launch (one per layer per microbatch, causal,
from its shapes) summed, over the device time of ``flash_bf16`` in the
trace.  The attention backward is no kernel and is not counted."""
from bench.harness import arith


def read(ctx):
    trace = ctx.get("trace")
    secs = trace.seconds(["flash_bf16"]) if trace is not None else None
    if not ctx.get("steps") or not secs:
        return None
    m, k = ctx["sizes"], ctx["accum_steps"]
    least = ctx["steps"] * k * m["n_layers"] * arith.flash_bound_s(
        ctx["batch"] // k, ctx["seq_len"], m["n_heads"], m["n_kv_heads"],
        m["head_dim"])
    return 100 * least / secs
