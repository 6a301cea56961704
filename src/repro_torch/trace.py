"""Spans of the port's own work: where a decode step, an admission or a
train step spends its time, with counts of what it did.

Tracing is on exactly while a ``torch.profiler`` session records, judged
by the profiler's own flag (one attribute read); there is no other switch.
While it is off, ``span`` returns one shared object that records nothing.
So whoever profiles the engine or the trainer gets the spans with the
device trace:

    from torch.profiler import ProfilerActivity, profile
    from repro_torch import trace

    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(8):
            engine.step()
    for s in trace.spans():
        print(s.name, s.parent, (s.t1_ns - s.t0_ns) / 1e6, s.device_ns,
              s.counts)

A span holds its id, the id of the span open around it on the same thread,
its name, a request id, its start and end on ``time.perf_counter_ns()``
and its counts.  ``time.time_ns() - time.perf_counter_ns()`` takes those
times to the profiler's clock, on which its events lie.  ``device=True``
also records a pair of CUDA events on the current stream, never waiting
for them; ``spans`` reads the device time between them (without a CUDA
context, the host interval stands in).  The pairs come from a pool: a new
device span first reads, without waiting, the pairs the card has passed,
and takes one of them back, so a steady loop creates no events.  The
buffer keeps the newest ``LIMIT`` spans.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import List, Optional

import torch
from torch.autograd import profiler as _profiler

LIMIT = 1 << 18
_done: deque = deque(maxlen=LIMIT)
_ids = itertools.count(1)
_open = threading.local()
_pool: list = []        # event pairs free to record again
_pending: deque = deque()   # closed device spans whose events are unread


class _Off:
    """What ``span`` returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __setitem__(self, key: str, value) -> None:
        return None


OFF = _Off()


class Span:
    """One recorded interval; set a count with ``s[name] = value`` before
    it closes."""
    __slots__ = ("id", "parent", "name", "rid", "t0_ns", "t1_ns", "counts",
                 "device_ns", "_events", "_outer")

    def __init__(self, name: str, rid: Optional[int], device: bool,
                 counts: dict):
        self.id = next(_ids)
        self.name, self.rid, self.counts = name, rid, counts
        self.parent = self._outer = None
        self.t0_ns = self.t1_ns = 0
        self.device_ns: Optional[int] = None
        self._events = None
        if device and torch.cuda.is_initialized():
            self._events = _pair()
        elif device:
            self.device_ns = 0          # the host interval, at the close

    def __enter__(self) -> "Span":
        self._outer = getattr(_open, "span", None)
        if self._outer is not None:
            self.parent = self._outer.id
        _open.span = self
        self.t0_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[0].record()
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            self._events[1].record()
            _pending.append(self)
        self.t1_ns = time.perf_counter_ns()
        if self.device_ns is not None:
            self.device_ns = self.t1_ns - self.t0_ns
        _open.span, self._outer = self._outer, None
        _done.append(self)

    def __setitem__(self, key: str, value) -> None:
        self.counts[key] = value


def _read(s: Span) -> None:
    s.device_ns = round(s._events[0].elapsed_time(s._events[1]) * 1e6)
    _pool.append(s._events)
    s._events = None


def _pair():
    """A free event pair: one the card has passed, else a new one."""
    while _pending and _pending[0]._events[1].query():
        _read(_pending.popleft())
    if _pool:
        return _pool.pop()
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def span(name: str, rid: Optional[int] = None, device: bool = False,
         **counts):
    """A context manager around one piece of the program's work: a new
    ``Span`` while tracing is on, else the shared ``OFF``."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return Span(name, rid, device, counts)


def spans(t0_ns: Optional[int] = None,
          t1_ns: Optional[int] = None) -> List[Span]:
    """The closed spans that start in [t0_ns, t1_ns) (perf clock; a bound
    left None takes all on its side), in order of start, their device times
    read (this waits for the events still unread)."""
    while _pending:
        s = _pending.popleft()
        s._events[1].synchronize()
        _read(s)
    return sorted((s for s in list(_done)
                   if (t0_ns is None or s.t0_ns >= t0_ns)
                   and (t1_ns is None or s.t0_ns < t1_ns)),
                  key=lambda s: s.t0_ns)


def reset() -> None:
    """Forget every recorded span."""
    _done.clear()
