"""The port's DeepSeek-V3 family (``arch_kind`` "mla_moe", Moonlight) on
the CPU against the benchmark's plain reference (`bench/reference/
mla_moe.py`), which shares no code with it: forward logits and balance
loss, loss and gradients of an accumulated step, the router's selection
and weights, a layer cut into held shares against the whole, the spans'
counts, and the correction bias left alone by the train step.

Weights from the benchmark's own draw (`bench/families/mla_moe.py`), the
program in fp32 (compute dtype float32), so that the two differ only in
the order of their sums: ~1e-6 of a value.  Every tolerance below is
1e-4 of the compared tensor's largest entry, and bf16 compute (8 bits of
mantissa, ~4e-3 a rounding) misses it by an order of magnitude or more.
"""
import dataclasses

import pytest
import torch

from bench.families import mla_moe as fam
from bench.harness import weights
from bench.reference import mla_moe as ref
from repro_torch import trace
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.train import AdamWConfig, TrainHyper, make_grad_fn, \
    make_train_step
from repro_torch.train.step import init_state

TOL = 1e-4
SMALL = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
             num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             vocab_size=512, router_experts=16, n_routed_experts=16,
             num_experts_per_tok=3, experts_first=0)
ROWS, SEQ = 4, 24


def _config(**over):
    cfg = {**weights.load_config("moonlight-16b-a3b.ep8-pp2"), **SMALL,
           **over}
    cfg["training"] = {**cfg["training"], "microbatch_rows": ROWS // 2}
    return cfg


def _setup(seed=3, attn="xla", **over):
    """(sizes, weights, the program's config) at small sizes."""
    cfg = _config(**over)
    m = fam.sizes(cfg)
    params = weights.draw(fam.shapes(m), seed, torch.float32,
                          torch.device("cpu"))
    pc = fam.program_config(cfg, m, "training").replace(
        compute_dtype="float32", attn_impl=attn)
    return m, params, pc


def _tokens(seed=0):
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, SMALL["vocab_size"], (ROWS, SEQ + 1), generator=g)
    return t[:, :-1].int(), t[:, 1:].int()


def _close(a, b, what):
    err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    assert err < TOL, f"{what}: {err:.3e} of the largest entry"


@pytest.fixture(autouse=True)
def exact():
    ref.exact_fp32()


def test_tree_is_the_benchmarks():
    """The port's schema is the benchmark's tree, leaf for leaf, and only
    the correction bias is kept out of training."""
    m, params, pc = _setup()
    model = get_model(pc)
    ours = {k: tuple(v.shape) for k, v in
            weights.leaves(model.init(0, device="cpu")).items()}
    theirs = {k: tuple(v.shape) for k, v in weights.leaves(params).items()}
    assert ours == theirs
    assert model.frozen() == {"layers/router_bias"}
    full = get_model(get_config("moonlight-16b-a3b"))
    # the published model: ~16 B parameters, ~3 B a token
    assert 15.9e9 < full.param_count() < 16.0e9
    assert 2.9e9 < full.active_param_count() < 3.0e9


@pytest.mark.parametrize("attn", ["xla", "pallas_interpret"])
def test_forward_and_balance_loss_match_reference(attn):
    m, params, pc = _setup(attn=attn)
    tok, _ = _tokens()
    logits, aux = get_model(pc).module.forward(params, {"tokens": tok}, pc,
                                               return_aux=True)
    rl, raux = ref.forward(params, m, tok)
    _close(logits.reshape(rl.shape), rl, "logits")
    assert float(aux) > 0
    _close(aux, raux, "balance loss")


@pytest.mark.parametrize("held_first,held", [(0, 16), (4, 2)])
def test_step_loss_and_grads_match_reference(held_first, held):
    """Two microbatches of two rows, capacity counted over each: the
    program's accumulated loss and every gradient leaf against the
    reference's (which recomputes each block alone)."""
    m, params, pc = _setup(experts_first=held_first, n_routed_experts=held)
    tok, lab = _tokens(1)
    grad_fn = make_grad_fn(get_model(pc), TrainHyper(accum_steps=2))
    loss, _, grads = grad_fn(params, {"tokens": tok, "labels": lab})
    rloss, rgrads = ref.grads(params, m, tok, lab)
    assert abs(float(loss) - rloss) < TOL * abs(rloss)
    ours = weights.leaves(grads)
    assert set(ours) == set(rgrads)
    for k, g in rgrads.items():
        if k == "layers/router_bias":
            assert not ours[k].any() and not g.any()
        else:
            _close(ours[k], g, k)


def test_router_selects_by_score_plus_bias_and_weights_by_score():
    """Selection follows s + b and the weights s (renormalised, × the
    routed scale); the test's comparison is tight enough that a wrong bias
    or weights taken from s + b fail it."""
    _, params, pc = _setup()
    m = pc.moe
    g = torch.Generator().manual_seed(5)
    flat = torch.randn((64, 64), generator=g)
    router = params["layers"]["router"][0]
    bias = params["layers"]["router_bias"][0]
    s = torch.sigmoid(flat @ router)
    _, top_p, top_e, _ = L.moe_route(router, flat, m, bias, rows=2)

    def chosen(b):
        return torch.topk(s + b, m.top_k, dim=-1).indices.sort(-1).values

    def weights_of(score, e):
        w = score.gather(-1, e)
        return w / w.sum(-1, keepdim=True) * m.routed_scale

    assert torch.equal(top_e.sort(-1).values, chosen(bias))
    _close(top_p, weights_of(s, top_e), "weights")
    # by s alone the choices differ: the bias moves the selection
    assert not torch.equal(chosen(torch.zeros_like(bias)), chosen(bias))
    assert not torch.equal(top_e.sort(-1).values, chosen(bias.flip(0)))
    with pytest.raises(AssertionError):
        _close(top_p, weights_of(s + bias, top_e), "weights from s + b")


def test_held_shares_add_up_to_the_whole_layer():
    """Eight disjoint shares of 2 experts of 16: each computes attention,
    the shared experts and its own experts' choices; the eight outputs,
    with attention and the shared experts counted once, are the uncut
    reference layer's."""
    m, params, pc = _setup()
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, SEQ, 64), generator=g)
    p = {k: v[0] for k, v in params["layers"].items()}
    positions = torch.arange(SEQ)[None, :]
    attn = L.mla_block(p, x, pc, positions=positions)
    h = x + attn
    shared = L.swiglu({"w_gate": p["shared_gate"], "w_up": p["shared_up"],
                       "w_down": p["shared_down"]},
                      L.rms_norm(h, p["ln2"], pc.norm_eps), pc,
                      pre_normed=True)
    total = torch.zeros_like(x)
    for first in range(0, 16, 2):
        cfg = pc.replace(moe=dataclasses.replace(pc.moe, held_first=first,
                                                 held=2))
        part = {**p, "ln": p["ln2"]}
        for n in ("w_gate", "w_up", "w_down"):
            part[n] = p[n][first:first + 2]
        out, _ = L.moe_block(part, h, cfg)
        total += h + out - shared
    total += shared - 7 * h
    whole, _ = ref.layer(x.reshape(-1, 64), p, m, False, 2, False, 1024)
    _close(total.reshape(-1, 64), whole, "the shares' sum")


def test_route_span_counts_held_and_dropped_choices():
    """While a profiler records, each expert layer's ``moe.route`` span
    counts its choices, those to held experts and those of them past
    capacity (as tensors), as the reference routes them."""
    m, params, pc = _setup(experts_first=4, n_routed_experts=4,
                           capacity_factor=0.5)
    tok, _ = _tokens(2)
    trace.reset()
    ref.ROUTE_LOG = []
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            get_model(pc).forward(params, {"tokens": tok})
        ref.forward(params, m, tok)         # one microbatch, as the call
        routes = ref.ROUTE_LOG
    finally:
        ref.ROUTE_LOG = None
    spans = trace.spans()
    got = [s for s in spans if s.name == "moe.route"]
    assert {"moe.dispatch", "moe.experts", "moe.combine",
            "moe.shared"} <= {s.name for s in spans}
    assert len(got) == len(routes) == 2     # two expert layers
    for s, r in zip(got, routes):
        held = (r["top_e"] >= 4) & (r["top_e"] < 8)
        assert s.counts["choices"] == ROWS * SEQ * 3
        assert int(s.counts["held_choices"]) == int(held.sum())
        assert int(s.counts["dropped_choices"]) \
            == int((held & ~r["keep"]).sum()) > 0


def test_train_step_leaves_the_correction_bias():
    """No AdamW step and no weight decay reach the bias; its moments stay
    0; every other leaf moves."""
    _, _, pc = _setup()
    model = get_model(pc)
    state = init_state(model, 0, device="cpu")
    state["params"]["layers"]["router_bias"].normal_()
    before = {k: v.clone() for k, v in
              weights.leaves(state["params"]).items()}
    step = make_train_step(model, TrainHyper(adamw=AdamWConfig(lr=1e-2,
                                                               warmup_steps=0),
                                             accum_steps=2))
    tok, lab = _tokens(3)
    for _ in range(2):
        state, _ = step(state, {"tokens": tok, "labels": lab})
    after = weights.leaves(state["params"])
    assert torch.equal(after["layers/router_bias"],
                       before["layers/router_bias"])
    assert not state["opt"].m["layers"]["router_bias"].any()
    assert int(state["opt"].count) == 2
    moved = [k for k in after if not torch.equal(after[k], before[k])]
    assert sorted(moved) == sorted(k for k in after
                                   if k != "layers/router_bias")


def test_smoke_config_trains():
    """The registry's smoke config through the step, flash's plain
    version at unequal head sizes included."""
    cfg = get_smoke_config("moonlight-16b-a3b").replace(
        attn_impl="pallas_interpret")
    model = get_model(cfg)
    state = init_state(model, 0, device="cpu")
    tok = torch.randint(0, cfg.vocab, (2, 17),
                        generator=torch.Generator().manual_seed(0))
    state, met = make_train_step(model)(state, {"tokens": tok[:, :-1],
                                                "labels": tok[:, 1:]})
    assert torch.isfinite(met["loss"]) and float(met["grad_norm"]) > 0
