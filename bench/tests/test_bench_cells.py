"""Each cell end to end on the CPU at small sizes, through the kernels'
plain versions: the result line the driver reads, and ``correct``; then
each fault the cell can have, planted under the timed path, must turn
``correct`` false."""
import json

import pytest
import torch

from bench.harness import cell
from bench.tests import smoke


def run(name, trace=False, seed=smoke.SEED):
    return cell.run(name, seed, smoke.SECONDS, trace, smoke.CPU,
                    t_process=0.0, config=smoke.config(name),
                    mix=smoke.mix(name), lim=smoke.limits(name))


@pytest.mark.parametrize("name", smoke.CELLS)
def test_cell_prints_a_correct_result_line(name):
    line = run(name)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in cell.benchmark()["end_to_end"]
            if name in m.get("workloads", [name])}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["device"]["count"] == 1
    json.loads(json.dumps(line, allow_nan=False))


@pytest.mark.parametrize("name", smoke.CELLS)
def test_traced_run_reads_the_span_metrics(name):
    line = run(name, trace=True)
    assert line["correct"] is True
    # no card here: the readers of the device trace find nothing, those
    # of the benchmark's spans do
    spans = {"prefill_ms_per_ktok.serve", "decode_step_ms.serve",
             "mfu.prefill", "mfu.decode"} if "serve" in name else \
        {"step_ms.train", "data_wait_ms.train", "mfu.train"}
    assert set(line["metrics"]) == spans


def altered_token(monkeypatch):
    """A decode step whose first row's token is not the one it computed."""
    from repro_torch.serving import engine
    real = engine._decode_step

    def step(*a, **k):
        tok = real(*a, **k)
        return torch.cat([(tok[:1] + 1) % 512, tok[1:]])
    monkeypatch.setattr(engine, "_decode_step", step)


def unchanged_state(monkeypatch):
    """A train step that returns its state unchanged."""
    from repro_torch.train import optimizer
    monkeypatch.setattr(optimizer, "update",
                        lambda cfg, grads, state, params:
                        (params, state, {"grad_norm": optimizer.global_norm(
                            grads), "lr": torch.zeros(())}))


def wrong_sign(monkeypatch):
    """A train step that applies its update with the wrong sign: every
    leaf's change has the norm it should have."""
    from repro_torch.models.common import tree_map
    from repro_torch.train import optimizer
    real = optimizer.update

    def update(cfg, grads, state, params):
        old = tree_map(torch.clone, params)
        params, state, metrics = real(cfg, grads, state, params)
        for p, o in zip(optimizer.leaves(params), optimizer.leaves(old)):
            p.copy_(2 * o - p)
        return params, state, metrics
    monkeypatch.setattr(optimizer, "update", update)


def swapped_leaves(monkeypatch):
    """A train step that gives the query projection the output
    projection's change and the other way round (leaves of one shape)."""
    from repro_torch.train import optimizer
    real = optimizer.update

    def update(cfg, grads, state, params):
        q, o = params["layers"]["wq"], params["layers"]["wo"]
        q0, o0 = q.clone(), o.clone()
        params, state, metrics = real(cfg, grads, state, params)
        dq, do = q - q0, o - o0
        q.copy_(q0 + do)
        o.copy_(o0 + dq)
        return params, state, metrics
    monkeypatch.setattr(optimizer, "update", update)


def half_batch(monkeypatch):
    """A train step over the first half of its batch alone."""
    from repro_torch.train import step
    real = step.make_grad_fn

    def make(model, hyper, rules=None):
        fn = real(model, hyper, rules)
        return lambda params, batch: fn(params, {
            k: v[: v.shape[0] // 2] for k, v in batch.items()})
    monkeypatch.setattr(step, "make_grad_fn", make)


@pytest.mark.parametrize("name,fault", [
    (smoke.SERVE, altered_token),
    (smoke.TRAIN, unchanged_state), (smoke.TRAIN, half_batch),
    (smoke.TRAIN, wrong_sign), (smoke.TRAIN, swapped_leaves)])
def test_a_fault_under_the_timed_path_is_not_correct(name, fault,
                                                     monkeypatch):
    fault(monkeypatch)
    line = run(name)
    assert line["correct"] is False, line["checks"]
