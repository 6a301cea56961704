"""The decode steps' share of their roofline, in %: each step's least time
on the card (the larger of its operations over 989 TFLOP/s and its bytes
over 3.35 TB/s; bytes: the weights once and the K/V of the tokens it reads,
a shared prefix once) summed, over the summed time of the ``Engine.step``
spans.  The bytes and operations are the model family's."""
from bench.harness import arith


def read(ctx):
    steps = ctx.get("steps", ())
    if not steps:
        return None
    m, fam = ctx["sizes"], ctx["family"]
    least = sum(arith.bound_s(fam.decode_bytes(m, unique),
                              fam.decode_flops(m, rows, keys))
                for _, _, rows, keys, _, unique in steps)
    return 100 * least / sum(t1 - t0 for t0, t1, *_ in steps)
