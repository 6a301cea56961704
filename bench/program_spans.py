"""The program's own spans (``repro_torch.trace``) inside a traced run's
window, for the readers in ``metrics/``.

The program records spans only while a profiler records, on
``time.perf_counter_ns()``; the context's ``epoch_offset_ns`` takes them to
the profiler's clock, on which the window and the device operations lie.
A program that records no spans of its own (one older than its tracer)
gives ``None``, as does a run with no trace.
"""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, Optional


def window(ctx: Dict) -> Optional[List]:
    """The program's spans that start inside the traced window, in order
    of start; None if there is no trace or none."""
    trace = ctx.get("trace")
    if trace is None:
        return None
    try:
        import repro_torch.trace as program
    except ImportError:
        return None
    off = ctx["epoch_offset_ns"]
    return program.spans(trace.t0_ns - off, trace.t1_ns - off) or None


def named(spans: List, name: str) -> List:
    return [s for s in spans if s.name == name]


def children(spans: List) -> Dict[int, Dict[str, List]]:
    """parent id → child name → the children, in order of start."""
    out: Dict[int, Dict[str, List]] = defaultdict(lambda: defaultdict(list))
    for s in spans:
        if s.parent is not None:
            out[s.parent][s.name].append(s)
    return out


def median_ms(values_ns: List[float]) -> Optional[float]:
    return statistics.median(values_ns) / 1e6 if values_ns else None


def per_step_device_ms(ctx: Dict, phase: str) -> Optional[float]:
    """Median over ``train.step`` spans of the summed device time of
    their ``phase`` children, in ms."""
    spans = window(ctx)
    if not spans:
        return None
    kids = children(spans)
    return median_ms([sum(k.device_ns for k in kids[s.id][phase])
                      for s in named(spans, "train.step")
                      if kids[s.id][phase]])
