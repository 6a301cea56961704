"""``flash_bwd_roofline.train``: its yardstick on the train cell's shape,
and what it reads from a trace."""
import importlib.util
import os

import pytest

from bench.families import dense
from bench.harness import arith, cell, weights
from bench.harness.trace import Trace

METRIC = "flash_bwd_roofline.train"
TRAIN = "smollm-360m.train.2k"
SMOLLM = dense.sizes(weights.load_config("smollm-360m"))


def _module():
    path = os.path.join(cell.BENCH_DIR, "metrics", f"{METRIC}.py")
    spec = importlib.util.spec_from_file_location("flash_bwd_metric", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_bound_of_one_call_at_the_train_microbatch():
    # B 4, S 2048, 15 heads over 5 of 64: five products of 2·64 operations
    # per visible pair, 80.6 GFLOP; eight [B, S, heads, 64] bf16 tensors,
    # 83.9 MB; so 0.0815 ms, set by operations (0.025 ms of bytes)
    flops = 10 * 64 * 4 * 15 * (2048 * 2049 // 2)
    nbytes = 2 * (4 * 4 * 2048 * 15 * 64 + 4 * 4 * 2048 * 5 * 64)
    assert flops == 80_569_958_400
    assert nbytes == 83_886_080
    assert flops == 5 * 4 * 64 * 4 * 15 * (2048 * 2049 // 2) // 2
    got = _module().bound_s(4, 2048, 15, 5, 64)
    assert got == pytest.approx(flops / 989e12, rel=1e-12)
    assert got == pytest.approx(8.1466e-5, rel=1e-4)
    assert nbytes / 3.35e12 == pytest.approx(2.504e-5, rel=1e-3)
    # 5/2 of the forward's operations
    assert got == pytest.approx(2.5 * arith.flash_bound_s(4, 2048, 15, 5, 64),
                                rel=1e-12)


def test_it_reads_the_backward_kernels_alone():
    read = cell.reader(METRIC)
    ctx = {"sizes": SMOLLM, "family": dense, "steps": 3, "batch": 8,
           "seq_len": 2048, "accum_steps": 2}
    calls = 3 * 2 * SMOLLM["n_layers"]
    least = calls * _module().bound_s(4, 2048, 15, 5, 64)
    ops = [("void (anonymous namespace)::flash_bwd<64>(CUtensorMap_st, ...)",
            0, 400_000),
           ("(anonymous namespace)::flash_bwd_prep<64>(...)", 1, 30_000),
           ("(anonymous namespace)::flash_bwd_dq<64>(...)", 2, 20_000),
           ("void (anonymous namespace)::flash_bf16<64>(...)", 3, 200_000),
           ("sm90_xmma_gemm_bf16bf16", 4, 1_000_000)]
    ops = [(n, s, d * calls) for n, s, d in ops]
    value = read(dict(ctx, trace=Trace(ops, 0, 10 ** 12)))
    assert value == pytest.approx(100 * least / (450e-6 * calls), rel=1e-9)
    # a parent without the kernel, and a run with no trace, read nothing
    assert read(dict(ctx, trace=Trace(ops[3:], 0, 10 ** 12))) is None
    assert read(dict(ctx, trace=None)) is None


def test_it_is_declared_for_the_train_cell():
    metric = next(m for m in cell.benchmark()["per_layer"]
                  if m["name"] == METRIC)
    assert metric == {"name": METRIC, "unit": "%", "better": "higher",
                      "source": "device_trace", "layer": "kernels",
                      "moves": "train_tok_s", "workloads": [TRAIN]}
