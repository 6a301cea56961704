"""The DeepSeek-V3 family (``bench/families/mla_moe.py``), its plain
reference and the readers of the Moonlight cell, on the CPU.

The family's parameter count at the configuration's sizes and its
operation and byte counts against hand counts; the reference's gradients
(each block recomputed alone) against autograd through its own forward;
the cell end to end at small sizes, ``correct``, and not ``correct`` under
a fault in the timed path; `bench/route_gaps.py` with the program's
routing given to the reference; the four readers on a traced CPU run and on a
synthetic trace, and nothing without a trace."""
import json
import math
import time

import pytest
import torch

from bench.families import mla_moe as fam
from bench.harness import arith, cell, train, traffic, weights
from bench.harness.trace import Trace
from bench.reference import mla_moe as ref
from bench.tests import smoke
from bench.tests.test_bench_cells import half_batch, unchanged_state, \
    wrong_sign
from bench.tests.test_bench_program_spans import CpuWindow

CELL = "moonlight-16b-a3b.train.4k"
CONFIG = "moonlight-16b-a3b.ep8-pp2"
NEW = ["moe_mfu.train", "moe_forward_ms.train", "flash_mla_roofline.train",
       "flash_mla_bwd_roofline.train"]
SMALL = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
             num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             vocab_size=512, router_experts=16, n_routed_experts=4,
             experts_first=8, num_experts_per_tok=3)
# fp32 compute at small sizes: the program and the reference differ by
# their sums' order (~1e-6); the faults read 0.3 and more
LIMITS = {"grad_norm_gap": 1e-3, "grad_leaf_gap": 1e-3,
          "grad_diff_leaf_gap": 1e-3, "update_leaf_gap": 1e-3,
          "update_diff_leaf_gap": 1e-3, "rows_not_in_corpus": 0}


def small_config(compute="float32"):
    cfg = {**weights.load_config(CONFIG), **SMALL}
    cfg["training"] = {**cfg["training"], "compute_dtype": compute}
    return cfg


def small_mix():
    return {**traffic.load("train.4k"), "global_batch": 8, "seq_len": 16,
            "corpus_steps": 4}


def test_shapes_count_the_configurations_parameters():
    """Stage 1 of 2 at EP 8: 1,472,069,632 weights in matrices and
    tables, 1,472,137,024 with the norm scales and the correction bias."""
    m = fam.sizes(weights.load_config(CONFIG))
    shapes = fam.shapes(m)
    count = {kind: sum(math.prod(s) for s, k in shapes.values() if k == kind)
             for kind in ("fan_in", "embed", "norm")}
    assert count["fan_in"] + count["embed"] == 1_472_069_632
    assert sum(count.values()) == 1_472_137_024
    assert (m["n_experts"], m["held"], m["top_k"], m["vocab"]) \
        == (64, 8, 6, 20480)


def test_train_flops_and_flash_counts_by_hand():
    """At d 8, 2 heads of 3 + 2 (nope + rope) and v 4, kv rank 6, dense
    width 10, expert width 5, shared 7, 4 experts of which 2 held, top 2,
    3 layers (1 dense), vocab 11, batch 2 of 5 tokens."""
    m = dict(d_model=8, n_heads=2, qk_nope=3, qk_rope=2, v_dim=4, kv_rank=6,
             d_ff=10, d_expert=5, d_shared=7, n_experts=4, held=2, top_k=2,
             n_layers=3, first_k_dense=1, vocab=11)
    attn = 8 * 2 * 5 + 8 * (6 + 2) + 6 * 2 * (3 + 4) + 2 * 4 * 8   # 292
    outside = 3 * attn + 1 * 3 * 8 * 10 + 2 * (8 * 4 + 3 * 8 * 7) + 11 * 8
    assert fam.dense_matmul_params(m) == outside == 1604
    pairs = 5 * 6 // 2
    attention = 3 * 2 * 2 * pairs * (5 + 4)                          # 1620
    held = 2 * 10 * 2 * 2 / 4                                        # 20
    assert fam.train_flops(m, 2, 5) == \
        6 * 1604 * 10 + 6 * 3 * 8 * 5 * held + 3 * 2 * attention
    assert fam.train_flops(m, 2, 5, routed_choices=7) == \
        6 * 1604 * 10 + 6 * 3 * 8 * 5 * 7 + 3 * 2 * attention
    assert fam.flash_fwd_counts(2, 5, 2, 1, 5, 4) == (
        2 * 2 * 2 * pairs * (5 + 4),
        2 * 2 * 5 * (2 * 5 + 1 * 5 + 1 * 4 + 2 * 4))
    assert fam.flash_bwd_counts(2, 5, 2, 1, 5, 4) == (
        2 * 2 * 2 * pairs * (3 * 5 + 2 * 4),
        2 * 2 * 5 * (2 * (5 + 4 + 4 + 5) + (5 + 4 + 5 + 4)))
    assert fam.flash_launches(m) == [(3, 2, 2, 5, 4)]


def test_reference_grads_equal_autograd_through_its_forward():
    """The per-block recompute gives autograd's gradients of the mean over
    microbatches of (cross-entropy + balance losses)."""
    ref.exact_fp32()
    cfg = small_config()
    m = fam.sizes(cfg)
    params = weights.draw(fam.shapes(m), 11, torch.float32, smoke.CPU)
    g = torch.Generator().manual_seed(1)
    t = torch.randint(0, 512, (4, 17), generator=g)
    tok, lab = t[:, :-1], t[:, 1:]
    loss, grads = ref.grads(params, m, tok, lab)
    flat = ref.leaves(params)
    live = {k: v.detach().requires_grad_() for k, v in flat.items()
            if k not in ref.FROZEN}
    tree = weights.tree({**flat, **live})
    total = 0.0
    for j in range(2):
        logits, aux = ref.forward(tree, m, tok[2 * j:2 * j + 2])
        total = total + (torch.nn.functional.cross_entropy(
            logits, lab[2 * j:2 * j + 2].reshape(-1)) + aux) / 2
    want = torch.autograd.grad(total, list(live.values()))
    assert loss == pytest.approx(float(total.detach()), rel=1e-6)
    for (k, _), w in zip(live.items(), want):
        err = float((grads[k] - w).abs().max() / w.abs().max())
        assert err < 1e-5, (k, err)
    assert not grads["layers/router_bias"].any()


def test_reference_adamw_leaves_the_correction_bias():
    ref.exact_fp32()
    h = weights.load_config(CONFIG)["training"]["adamw"]
    params = {"layers/router_bias": torch.ones(2, 4),
              "layers/wq": torch.ones(2, 3, 4)}
    grads = {k: torch.full_like(v, 0.5) for k, v in params.items()}
    state = {}
    ref.adamw({**h, "warmup_steps": 0}, params, grads, state, 1)
    assert torch.equal(params["layers/router_bias"], torch.ones(2, 4))
    assert not torch.equal(params["layers/wq"], torch.ones(2, 3, 4))
    assert all(v.device.type == "cpu" for v in state.values())


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_route_gaps_given_the_programs_routing(compute):
    """`bench/route_gaps.py` hands the reference every choice the program
    made, in the order its layers run them (no flip left, none to spare).
    In fp32 the two read the same with either routing (sums' order,
    ~1e-6 at these sizes; a fault reads 0.3 and more); in bf16 this seed's
    flips (~1 % of the choices) are most of the gradient's gap, which the
    choices given take away (0.096 → 0.031)."""
    from bench import route_gaps
    r = route_gaps.readings(small_config(compute), small_mix(), smoke.SEED,
                            smoke.CPU)
    assert r["given"]["flip_share"] == 0.0
    for name in ("own", "given"):
        for num, top in r[name]["worst"].items():
            assert top[0][1] == pytest.approx(r[name]["gaps"][num],
                                              rel=1e-9)
            assert [v for _, v in top] == sorted((v for _, v in top),
                                                 reverse=True)
    if compute == "float32":
        for name in ("own", "given"):
            gaps = r[name]["gaps"]
            assert max(gaps[k] for k in LIMITS if k in gaps) < 1e-3, gaps
    else:
        assert r["own"]["flip_share"] > 0.0
        assert r["given"]["gaps"]["grad_diff_leaf_gap"] \
            < 0.5 * r["own"]["gaps"]["grad_diff_leaf_gap"]


def run(seed=smoke.SEED, trace=False):
    return cell.run(CELL, seed, smoke.SECONDS, trace, smoke.CPU,
                    t_process=0.0, config=small_config(), mix=small_mix(),
                    lim=LIMITS)


def test_cell_prints_a_correct_result_line():
    line = run()
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"train_tok_s", "setup_s"}
    assert line["attempted"] > 0 and line["failed"] == 0
    json.loads(json.dumps(line, allow_nan=False))


@pytest.mark.parametrize("fault", [unchanged_state, half_batch, wrong_sign])
def test_a_fault_under_the_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    line = run()
    assert line["correct"] is False, line["checks"]


def traced_ctx(profiled=True):
    """A small run of the cell with its window traced by the CPU profiler,
    and the reader context ``cell.run`` builds from it."""
    tracer = CpuWindow(profiled)
    out = train.run(small_config("bfloat16"), small_mix(), smoke.SEED,
                    smoke.SECONDS, smoke.CPU, tracer, 0.0)
    ctx = dict(out["ctx"])
    ctx["epoch_offset_ns"] = time.time_ns() - int(time.perf_counter() * 1e9)
    ctx["trace"] = tracer.read()
    return ctx


def test_new_metrics_are_declared_for_the_cell_alone():
    declared = {m["name"]: m for m in cell.benchmark()["per_layer"]}
    for name in NEW:
        assert declared[name]["workloads"] == [CELL]
        assert declared[name]["moves"] == "train_tok_s"
    e2e = {m["name"]: m for m in cell.benchmark()["end_to_end"]}
    assert CELL in e2e["train_tok_s"]["workloads"]


def test_span_readers_read_a_traced_run_and_nothing_without():
    ctx = traced_ctx()
    mfu = cell.reader("moe_mfu.train")(ctx)
    moe_ms = cell.reader("moe_forward_ms.train")(ctx)
    assert mfu is not None and mfu > 0
    assert moe_ms is not None and moe_ms > 0
    # CPU operators: no kernel of the card
    for name in NEW[2:]:
        assert cell.reader(name)(ctx) is None
    off = traced_ctx(profiled=False)
    for name in NEW:
        assert cell.reader(name)(off) is None
    assert cell.reader("moe_mfu.train")({**ctx, "trace": None}) is None


def test_flash_readers_on_a_synthetic_trace():
    m = fam.sizes(weights.load_config(CONFIG))
    ops = [("void (anonymous namespace)::flash_bf16<192, 128>(...)", 0,
            400_000_000),
           ("void (anonymous namespace)::flash_bwd<192, 128>(...)", 1,
            900_000_000),
           ("void (anonymous namespace)::flash_bwd_prep<192, 128>(...)", 2,
            50_000_000),
           ("void (anonymous namespace)::flash_bwd_dq<192, 128>(...)", 3,
            50_000_000),
           ("void (anonymous namespace)::flash_bf16<64, 64>(...)", 4,
            10**9)]
    ctx = {"sizes": m, "family": fam, "steps": 10, "batch": 8,
           "seq_len": 4096, "accum_steps": 4,
           "trace": Trace(ops, 0, 10**10)}
    launches = 10 * 4 * 14
    fwd = arith.bound_s(*reversed(fam.flash_fwd_counts(2, 4096, 16, 16, 192,
                                                       128)))
    bwd = arith.bound_s(*reversed(fam.flash_bwd_counts(2, 4096, 16, 16, 192,
                                                       128)))
    assert cell.reader("flash_mla_roofline.train")(ctx) == \
        pytest.approx(100 * launches * fwd / 0.4, rel=1e-12)
    assert cell.reader("flash_mla_bwd_roofline.train")(ctx) == \
        pytest.approx(100 * launches * bwd / 1.0, rel=1e-12)
    # ~0.174 ms a forward at the microbatch (operations)
    assert fwd == pytest.approx(2 * 2 * 16 * 4096 * 4097 / 2 * 320 / 989e12)
    assert cell.reader("flash_mla_roofline.train")(
        {**ctx, "trace": Trace(ops[4:], 0, 10**10)}) is None
