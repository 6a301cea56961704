"""The flash backward kernel's share of its roofline in the train steps,
in %: the least time of every backward launch (one per layer per
microbatch, causal, from its shapes) summed, over the device time of
every operation whose name holds ``flash_bwd`` (the kernel, its pre-pass
and its post-pass).  A program without that kernel reads nothing."""
from bench.harness import arith


def bound_s(b: int, s: int, h: int, hkv: int, d: int) -> float:
    """One causal backward: five products over the visible pairs (QKᵀ,
    dO·Vᵀ, Pᵀ·dO, dSᵀ·Q, dS·K), 2·d operations each per pair and head, 5/2
    of the forward's; q, out, dout and dq, k, v, dk and dv once, bf16."""
    flops = 10 * d * b * h * arith.causal_pairs(s)
    nbytes = arith.BF16_BYTES * (4 * b * s * h * d + 4 * b * s * hkv * d)
    return arith.bound_s(nbytes, flops)


def read(ctx):
    trace = ctx.get("trace")
    secs = trace.seconds(["flash_bwd"]) if trace is not None else None
    if not ctx.get("steps") or not secs:
        return None
    m, k = ctx["sizes"], ctx["accum_steps"]
    least = ctx["steps"] * k * m["n_layers"] * bound_s(
        ctx["batch"] // k, ctx["seq_len"], m["n_heads"], m["n_kv_heads"],
        m["head_dim"])
    return 100 * least / secs
