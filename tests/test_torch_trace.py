"""The port's tracer (``repro_torch.trace``) on the CPU: on exactly while a
``torch.profiler`` session records; the spans and counts of the serving
engine and of the train step, their nesting and order; the clock they
share with the profiler."""
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import trace
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.serving import Engine, EngineConfig
from repro_torch.train import optimizer as opt
from repro_torch.train.step import TrainHyper, make_train_step

STEP_CHILDREN = ["engine.step.prepare", "engine.step.upload",
                 "engine.step.forward", "engine.step.sync",
                 "engine.step.post"]


@pytest.fixture(autouse=True)
def empty():
    trace.reset()
    yield
    trace.reset()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def engine(pages=64):
    model = get_model(get_smoke_config("smollm-360m").replace(
        compute_dtype="float32"))
    return Engine(model, model.init(0, device="cpu"),
                  EngineConfig(page_tokens=4, num_pages=pages, device="cpu"))


def serve(eng):
    """A root, a fork of it that ends mid-page, and decode to the end."""
    a = eng.add(np.array([3, 1, 4, 1, 5, 9], np.int32), max_new=3)
    b = eng.add(np.array([3, 1, 4, 1, 5, 9, 2, 6, 5], np.int32), max_new=4,
                fork_from=a)
    while not all(eng._requests[s].done for s in (a, b)):
        eng.step()
    return a, b


def train(accum, steps=1):
    model = get_model(get_smoke_config("smollm-360m").replace(
        compute_dtype="float32", accum_steps=accum))
    params = model.init(0, device="cpu")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(model, TrainHyper(accum_steps=accum))
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, model.cfg.vocab, (4, 16), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    for _ in range(steps):
        state, metrics = step(state, batch)
    return metrics


def by_parent(spans):
    out = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s)
    return out


def test_the_profiler_flag_the_tracer_reads():
    """The tracer's one switch is this attribute of torch's profiler
    module: a torch that moves it must fail here, not trace nothing."""
    assert autograd_profiler._is_profiler_enabled is False
    assert trace.span("x") is trace.OFF
    with cpu_profile():
        assert autograd_profiler._is_profiler_enabled is True
        assert isinstance(trace.span("x"), trace.Span)
    assert autograd_profiler._is_profiler_enabled is False
    # started and stopped, as the benchmark's traced window does
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    assert isinstance(trace.span("x"), trace.Span)
    prof.stop()
    assert trace.span("x") is trace.OFF


def test_off_the_engine_and_a_train_step_record_nothing():
    assert trace.span("engine.step") is trace.OFF
    assert trace.span("x", rid=3, device=True, n=1) is trace.OFF
    with trace.span("x") as s:
        s["n"] = 1
    serve(engine())
    train(accum=2)
    assert trace.spans() == []


def test_engine_spans_nest_and_count():
    eng = engine()
    with cpu_profile():
        a, b = serve(eng)
    spans = trace.spans()
    kids = by_parent(spans)
    adds = [s for s in spans if s.name == "engine.add"]
    assert [s.rid for s in adds] == [a, b]
    assert [s.parent for s in adds] == [None, None]
    # the root computes its 6 tokens; the fork holds them cached, and its
    # prefill still runs its whole prompt through the forward
    assert [s.counts for s in adds] == [
        {"prompt_tokens": 6, "cached_tokens": 0, "computed_tokens": 6},
        {"prompt_tokens": 9, "cached_tokens": 6, "computed_tokens": 9}]
    assert all(add.id not in kids for add in adds)
    steps = [s for s in spans if s.name == "engine.step"]
    assert len(steps) == 3 and all(s.parent is None for s in steps)
    assert all(s.counts["pool_pages"] == 64 for s in steps)
    # at the end of the last step: both sequences' pages and the scratch
    assert steps[-1].counts["pages_in_use"] \
        == 64 - eng.cache.free_pages() == eng.cache.in_use() == 5
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent is not None:
            outer = next(p for p in spans if p.id == s.parent)
            assert outer.t0_ns <= s.t0_ns and s.t1_ns <= outer.t1_ns
        # without a CUDA context the host interval stands in
        if s.name.endswith(".forward"):
            assert s.device_ns == s.t1_ns - s.t0_ns
        else:
            assert s.device_ns is None


def test_a_fork_of_a_whole_prompt_computes_nothing():
    """A fork whose prompt is all shared prefix runs no prefill."""
    eng = engine()
    a = eng.add(np.array([3, 1, 4, 1, 5], np.int32), max_new=1)
    with cpu_profile():
        eng.add(np.array([3, 1, 4, 1, 5], np.int32), max_new=2, fork_from=a)
    (add,) = trace.spans()
    assert add.counts == {"prompt_tokens": 5, "cached_tokens": 5,
                          "computed_tokens": 0}


def test_the_step_children_tile_the_step_in_order():
    with cpu_profile():
        serve(engine())
    spans = trace.spans()
    kids = by_parent(spans)
    for step in (s for s in spans if s.name == "engine.step"):
        parts = kids[step.id]
        assert [k.name for k in parts] == STEP_CHILDREN
        assert step.t0_ns <= parts[0].t0_ns
        for before, after in zip(parts, parts[1:]):
            assert before.t1_ns <= after.t0_ns
        assert parts[-1].t1_ns <= step.t1_ns


@pytest.mark.parametrize("accum", [1, 2])
def test_a_train_step_has_a_forward_and_backward_per_microbatch(accum):
    with cpu_profile():
        train(accum)
    spans = trace.spans()
    (step,) = [s for s in spans if s.name == "train.step"]
    assert step.counts == {"tokens": 4 * 16} and step.parent is None
    assert [k.name for k in by_parent(spans)[step.id]] == \
        ["train.forward", "train.backward"] * accum + ["train.optimizer"]
    assert all(s.parent == step.id for s in spans if s is not step)


def test_the_traced_step_computes_what_the_untraced_one_does():
    """The backward span adds each microbatch's grads into the sum: the
    loss and the gradient norm are those of the step run untraced."""
    off = train(accum=2, steps=2)
    with cpu_profile():
        on = train(accum=2, steps=2)
    for k in ("loss", "grad_norm"):
        assert float(on[k]) == float(off[k])


def test_a_profiler_range_inside_a_span_lies_inside_it_on_its_clock():
    """The spans' perf clock, shifted by the offset the benchmark takes
    (``time.time_ns() - perf_counter``), is the profiler's clock."""
    with cpu_profile() as prof:
        with trace.span("outer") as outer:
            time.sleep(0.002)
            with record_function("inside"):
                time.sleep(0.005)
            time.sleep(0.002)
    off = time.time_ns() - int(time.perf_counter() * 1e9)
    (e,) = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "inside"]
    ms = 1_000_000
    assert outer.t0_ns + off - ms <= e.start_ns()
    assert e.start_ns() + e.duration_ns() <= outer.t1_ns + off + ms
    assert e.duration_ns() >= 5 * ms


def test_spans_are_filtered_by_start_and_the_buffer_is_bounded():
    with cpu_profile():
        with trace.span("first"):
            pass
        mid = time.perf_counter_ns()
        with trace.span("second"):
            pass
    assert [s.name for s in trace.spans()] == ["first", "second"]
    assert [s.name for s in trace.spans(mid)] == ["second"]
    assert [s.name for s in trace.spans(None, mid)] == ["first"]
    assert trace._done.maxlen == trace.LIMIT
    trace.reset()
    assert trace.spans() == []


class FakeEvent:
    """A CUDA event's calls, on the host clock; ``passed`` says whether
    the card has reached it."""
    made = 0
    passed = True

    def __init__(self, enable_timing):
        FakeEvent.made += 1
        self.t = None

    def record(self):
        self.t = time.perf_counter_ns()

    def query(self):
        return FakeEvent.passed

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


@pytest.mark.parametrize("passed,made", [(True, 2), (False, 2 * 50)])
def test_device_spans_take_back_the_event_pairs_the_card_passed(
        monkeypatch, passed, made):
    """A loop whose events the card has passed records every span on one
    pair; while none has passed, each span takes a new one.  Each span's
    device time is read all the same."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(trace, "_pool", [])
    monkeypatch.setattr(trace, "_pending", type(trace._pending)())
    monkeypatch.setattr(FakeEvent, "made", 0)
    monkeypatch.setattr(FakeEvent, "passed", passed)
    with cpu_profile():
        for _ in range(50):
            with trace.span("x", device=True):
                time.sleep(0.0002)
    assert FakeEvent.made == made
    spans = trace.spans()
    assert len(spans) == 50 and not trace._pending
    for s in spans:
        assert s._events is None
        assert 0 < s.device_ns <= s.t1_ns - s.t0_ns
    assert len(trace._pool) == made // 2
