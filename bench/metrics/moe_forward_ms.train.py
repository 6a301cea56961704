"""Median milliseconds, over the window's train steps, of the expert
layers' forward device time: the program's ``moe.route``,
``moe.dispatch``, ``moe.experts``, ``moe.combine`` and ``moe.shared``
spans (CUDA events at their starts and ends) inside each microbatch's
``train.forward``, summed over the step.  A program without those spans
reads nothing."""
from bench import program_spans as ps


def read(ctx):
    spans = ps.window(ctx)
    if not spans:
        return None
    kids = ps.children(spans)
    per_step = []
    for step in ps.named(spans, "train.step"):
        moe = [k for fwd in kids[step.id]["train.forward"]
               for name, ks in kids[fwd.id].items() if name.startswith("moe.")
               for k in ks]
        if moe:
            per_step.append(sum(k.device_ns for k in moe))
    return ps.median_ms(per_step)
