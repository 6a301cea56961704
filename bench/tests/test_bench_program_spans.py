"""The readers of the program's own spans (``bench/program_spans.py`` and
the metrics that use it) on the CPU: each cell's small run under a CPU
profiler, its window traced as ``bench/harness/trace.py`` traces the
card's, the profiler's CPU operators standing in for the card's
operations."""
import sys
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from bench.harness import cell, serve, train
from bench.harness.trace import Trace
from bench.tests import smoke

NEW = {smoke.SERVE: ["decode_prep_ms.serve", "decode_forward_ms.serve",
                     "decode_launch_gap_ms.serve",
                     "prefill_useful_share.serve",
                     "kv_pool_peak_share.serve"],
       smoke.TRAIN: ["forward_ms.train", "backward_ms.train",
                     "optimizer_ms.train"]}
READERS = [(c, m) for c, ms in NEW.items() for m in ms]


class CpuWindow:
    """``trace.Window``'s calls, with the CPU profiler; ``profiled=False``
    marks the window and starts no profiler."""

    def __init__(self, profiled=True):
        self.prof = profile(activities=[ProfilerActivity.CPU]) \
            if profiled else None
        self.t0_ns = self.t1_ns = 0

    def start(self):
        if self.prof is not None:
            self.prof.start()

    def mark_open(self):
        self.t0_ns = time.time_ns()

    def stop(self):
        self.t1_ns = time.time_ns()
        if self.prof is not None:
            self.prof.stop()

    def read(self):
        ops = [] if self.prof is None else [
            (e.name(), e.start_ns(), e.duration_ns())
            for e in self.prof.profiler.kineto_results.events()
            if self.t0_ns <= e.start_ns() < self.t1_ns]
        return Trace(ops, self.t0_ns, self.t1_ns)


def traced_ctx(name, profiled=True):
    """A small run of cell ``name`` with its window traced, and the reader
    context ``cell.run`` builds from it."""
    tracer = CpuWindow(profiled)
    run = serve.run if "serve" in name else train.run
    out = run(smoke.config(name), smoke.mix(name), smoke.SEED,
              smoke.SECONDS, smoke.CPU, tracer, 0.0)
    ctx = dict(out["ctx"])
    ctx["epoch_offset_ns"] = time.time_ns() - int(time.perf_counter() * 1e9)
    ctx["trace"] = tracer.read()
    return ctx


@pytest.fixture(scope="module")
def profiled():
    return {name: traced_ctx(name) for name in smoke.CELLS}


@pytest.fixture(scope="module")
def unprofiled():
    return {name: traced_ctx(name, profiled=False) for name in smoke.CELLS}


def test_every_new_metric_is_declared_for_its_cell():
    declared = {m["name"]: m for m in cell.benchmark()["per_layer"]}
    for name, metric in READERS:
        assert declared[metric]["workloads"] == [name]


@pytest.mark.parametrize("name,metric", READERS)
def test_each_new_reader_reads_a_number(profiled, name, metric):
    value = cell.reader(metric)(profiled[name])
    assert isinstance(value, float) and value >= 0, value


@pytest.mark.parametrize("name,metric", READERS)
def test_each_new_reader_finds_nothing_where_the_program_recorded_none(
        unprofiled, name, metric):
    assert cell.reader(metric)(unprofiled[name]) is None


@pytest.mark.parametrize("name,metric", READERS)
def test_each_new_reader_finds_nothing_in_a_program_without_spans(
        profiled, monkeypatch, name, metric):
    """A program older than its tracer (the parent's, in a comparison):
    no number, and no exception."""
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert cell.reader(metric)(profiled[smoke.SERVE]) is None
    assert cell.reader(metric)(profiled[smoke.TRAIN]) is None


def test_the_useful_share_is_the_harness_spans_share(profiled):
    """A prefill runs its whole prompt through the forward, so the
    program's counts give, exactly, the share the benchmark's own spans
    around ``Engine.add`` give over the same window."""
    ctx = profiled[smoke.SERVE]
    adds = [s for s in ctx["spans"] if s[0] == "engine.add"]
    prompt = sum(n for *_, n, _ in adds)
    cached = sum(c for *_, c in adds)
    assert adds and cached > 0
    assert cell.reader("prefill_useful_share.serve")(ctx) \
        == 100 * (prompt - cached) / prompt


def test_the_useful_share_reads_what_the_prefill_computes(monkeypatch):
    """The share follows the program's ``computed_tokens``, not the
    traffic: an engine whose prefills count the suffix alone reads 100 %."""
    from repro_torch.serving.engine import Engine
    real = Engine._run_prefill

    def suffix_only(self, sid, prompt, start, span):
        tok = real(self, sid, prompt, start, span)
        span["computed_tokens"] = len(prompt) - start
        return tok

    monkeypatch.setattr(Engine, "_run_prefill", suffix_only)
    assert cell.reader("prefill_useful_share.serve")(
        traced_ctx(smoke.SERVE)) == 100


def test_the_program_spans_pair_with_the_harness_spans(profiled):
    """One program ``engine.step`` inside each benchmark span around
    ``Engine.step`` (both on the perf clock), one ``train.step`` inside
    each around ``train_step``, with a forward and a backward per
    microbatch."""
    from bench import program_spans as ps
    for name, outer, inner in ((smoke.SERVE, "engine.step", "engine.step"),
                               (smoke.TRAIN, "train_step", "train.step")):
        ctx = profiled[name]
        spans = ps.named(ps.window(ctx), inner)
        bench = [s for s in ctx["spans"] if s[0] == outer]
        assert len(spans) == len(bench) > 0
        for s, (_, t0, t1, *_) in zip(spans, bench):
            assert t0 * 1e9 - 1e6 <= s.t0_ns <= s.t1_ns <= t1 * 1e9 + 1e6
    ctx = profiled[smoke.TRAIN]
    kids = ps.children(ps.window(ctx))
    k = ctx["accum_steps"]
    for s in ps.named(ps.window(ctx), "train.step"):
        assert [len(kids[s.id][n]) for n in ("train.forward",
                                             "train.backward",
                                             "train.optimizer")] == [k, k, 1]
