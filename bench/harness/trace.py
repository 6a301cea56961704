"""The device's side of a traced run: ``torch.profiler`` over the measured
window, with CUDA activity alone, read straight from its raw events.

The reading is that of ``chip_smoke.py``'s ``profile_window`` and
``device_ops``: every operation the card ran (kernels, copies, fills) with
its device time; busy time is their union over the window; the idle gaps
between them are labelled by the benchmark's host span that was open when
each gap began.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class Window:
    """The profiler around a measured window.  ``start`` (in set-up) and
    ``stop`` (at the window's close); ``read`` afterwards."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0_ns = self.t1_ns = 0

    def start(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.prof.start()
        torch.cuda.synchronize()

    def mark_open(self) -> None:
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.stop()

    def read(self) -> "Trace":
        ops = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type().name != "CUDA":
                continue
            s = e.start_ns()
            if self.t0_ns <= s < self.t1_ns:
                ops.append((e.name(), s, e.duration_ns()))
        return Trace(ops, self.t0_ns, self.t1_ns)


class Trace:
    """The device operations of a window: (name, start ns, duration ns),
    host epoch clock, as the profiler gives them."""

    def __init__(self, ops: List[Tuple[str, int, int]], t0_ns: int,
                 t1_ns: int):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.t0_ns, self.t1_ns = t0_ns, t1_ns

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def intervals(self) -> np.ndarray:
        """The union of the operations' intervals, clipped to the window,
        as [[start, end], ...] ns."""
        if not self.ops:
            return np.zeros((0, 2), np.int64)
        iv = np.array([(s, s + d) for _, s, d in self.ops], np.int64)
        iv = np.clip(iv, self.t0_ns, self.t1_ns)
        out = [list(iv[0])]
        for s, e in iv[1:]:
            if s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return np.array(out, np.int64)

    def busy_s(self) -> float:
        iv = self.intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9

    def seconds(self, names: Sequence[str]) -> Optional[float]:
        """Device seconds of the operations whose name holds any of
        ``names``; None if there is none."""
        hits = [d for n, _, d in self.ops if any(k in n for k in names)]
        return sum(hits) / 1e9 if hits else None

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for n, _, d in self.ops:
            by[n] += d / 1e9
        return [[n[:120], t] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, spans: Sequence[tuple], epoch_offset_ns: int,
                  k: int = 10) -> List[list]:
        """The window's idle time summed by what the host was doing when
        each gap began: the name of the benchmark span open then (spans
        are (name, start s, end s, ...) on the host's perf clock; the
        offset takes them to the profiler's epoch clock), or "harness"
        between spans."""
        iv = self.intervals()
        starts = np.concatenate([[self.t0_ns], iv[:, 1]])
        ends = np.concatenate([iv[:, 0], [self.t1_ns]])
        sp = sorted((int(s * 1e9) + epoch_offset_ns,
                     int(e * 1e9) + epoch_offset_ns, n)
                    for n, s, e, *_ in spans)
        sp_starts = np.array([s for s, _, _ in sp], np.int64)
        by: Dict[str, float] = defaultdict(float)
        for g0, g1 in zip(starts, ends):
            if g1 <= g0:
                continue
            i = int(np.searchsorted(sp_starts, g0, side="right")) - 1
            label = sp[i][2] if i >= 0 and sp[i][1] > g0 else "harness"
            by[label] += (g1 - g0) / 1e9
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])
                ][:k]
