"""The reference against the port at small sizes on the CPU, both in
fp32 on the same weights: served logits against the port's forward, the
loss and its gradients against the port's gradient step, AdamW against
the port's optimizer."""
import numpy as np
import torch

from bench.families import dense
from bench.harness import weights
from bench.reference import dense as ref
from bench.tests import smoke


def port(name, **kw):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import get_model
    m = dense.sizes(smoke.config(name))
    cfg = ModelConfig(name="smoke", arch_kind="dense", param_dtype="float32",
                      compute_dtype="float32", **kw, **m)
    return m, get_model(cfg)


def test_served_logits_match_the_port_forward():
    m, model = port(smoke.SERVE)
    params = weights.draw(dense.shapes(m), 7, torch.float32, smoke.CPU)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, m["vocab"], (2, 40)))
    want = model.forward(params, {"tokens": toks})
    got = ref.served_logits(params, m, list(toks),
                            [torch.arange(40)] * 2, attn_block=16)["fp32"]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_loss_grads_and_adamw_match_the_port_step():
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import TrainHyper, make_grad_fn
    m, model = port(smoke.TRAIN)
    params = weights.draw(dense.shapes(m), 8, torch.float32, smoke.CPU)
    rows = torch.from_numpy(np.random.default_rng(1).integers(
        0, m["vocab"], (4, 33)))
    tok, lab = rows[:, :-1], rows[:, 1:]
    loss, _, grads = make_grad_fn(model, TrainHyper())(
        params, {"tokens": tok, "labels": lab})
    rloss, rgrads = ref.grads(params, m, tok, lab)
    assert abs(float(loss) - rloss) < 1e-5 * abs(rloss)
    flat = ref.leaves(grads)
    for k, g in rgrads.items():
        torch.testing.assert_close(g, flat[k], rtol=1e-4, atol=1e-6)

    h = smoke.config(smoke.TRAIN)["training"]["adamw"]
    # a warm-up this short moves the weights visibly in two steps
    h = {**h, "warmup_steps": 2, "lr": 1e-2}
    mine = {k: v.clone() for k, v in ref.leaves(params).items()}
    state, theirs = {}, params
    ostate = opt.init(params)
    for step in (1, 2):
        gn = ref.adamw(h, mine, {k: g.clone() for k, g in flat.items()},
                       state, step)
        theirs, ostate, om = opt.update(opt.AdamWConfig(**h), grads, ostate,
                                        theirs)
        assert abs(float(om["grad_norm"]) - gn) < 1e-5 * gn
    for k, v in ref.leaves(theirs).items():
        torch.testing.assert_close(mine[k], v, rtol=1e-5, atol=1e-7)
