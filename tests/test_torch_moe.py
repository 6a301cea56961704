"""The port's MoE family (olmoe-1b-7b, granite-moe-3b-a800m) on the CPU
against the JAX package: `moe_block` with and without dropped choices,
forward and its aux loss, decode (dropless against forward, and with the
batch-dependent drops against JAX's decode), one train step with and
without gradient accumulation, granite's padded experts, and the
parameter counts.  Same inputs (numpy, from a seed) and the same params
(JAX `Model.init`, carried across with `repro_torch.weights.from_numpy`),
fp32 compute.

Routing is discrete: where a check fails, first read the smallest top-k
margin each test prints (the gap between the k-th and the (k+1)-th router
probability); a choice at fp32 rounding may flip between two frameworks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro.train import AdamWConfig as JAdamW
from repro.train import TrainHyper as JHyper
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_train_step
from repro_torch import configs as tconfigs
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.train import (AdamWConfig, TrainHyper, make_grad_fn,
                               make_train_step)
from repro_torch.weights import from_numpy
from test_torch_train import ADAMW, _batch, _close_trees, _np, _to_port

ARCHS = ["olmoe-1b-7b", "granite-moe-3b-a800m"]
B, S = 2, 16
TOL = 2e-3                       # the reference's decode/forward tolerance


def _cfg(arch, capacity_factor=None, **kw):
    cfg = tconfigs.get_smoke_config(arch).replace(compute_dtype="float32",
                                                  max_seq=S, **kw)
    if capacity_factor is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def _dropless(arch, **kw):
    """Capacity = every token: the regime where decode equals forward
    (tests/test_decode_consistency.py)."""
    m = tconfigs.get_smoke_config(arch).moe
    return _cfg(arch, capacity_factor=m.num_experts / m.top_k, **kw)


def _params(cfg, seed=0):
    jparams = jax_get_model(cfg).init(jax.random.PRNGKey(seed))
    return jparams, from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _margin(probs, k) -> float:
    """Smallest gap between the k-th and (k+1)-th router probability."""
    top = torch.topk(probs, k + 1, dim=-1).values
    return float((top[:, k - 1] - top[:, k]).min())


# --------------------------------------------------------------- moe_block
@pytest.mark.parametrize("regime", ["dropless", "overflow"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax(arch, regime):
    """out and aux at 1e-5, the same experts chosen; with a capacity
    factor of 1 choices overflow, so the overflow row and the slot order
    are exercised."""
    cfg = _dropless(arch) if regime == "dropless" \
        else _cfg(arch, capacity_factor=1.0)
    jparams, tparams = _params(cfg, seed=1)
    jp = {k: v[0] for k, v in jparams["layers"].items()}
    tp = {k: v[0] for k, v in tparams["layers"].items()}
    jp["ln"], tp["ln"] = jp["ln2"], tp["ln2"]
    x = np.random.default_rng(2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    ref, ref_aux = JL.moe_block(jp, jnp.asarray(x), cfg)
    TL.ROUTE_LOG = []
    try:
        out, aux = TL.moe_block(tp, torch.from_numpy(x), cfg)
        (routed,) = TL.ROUTE_LOG
    finally:
        TL.ROUTE_LOG = None
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=1e-5,
                               rtol=1e-5)

    m = cfg.moe
    flat = TL.rms_norm(torch.from_numpy(x), tp["ln"],
                       cfg.norm_eps).reshape(B * S, -1)
    jflat = jnp.asarray(flat.numpy())
    jprobs = jax.nn.softmax(jflat @ jp["router"], axis=-1)
    _, jtop_e = jax.lax.top_k(jprobs, m.top_k)
    top_e, keep = routed["top_e"], routed["keep"]
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))
    np.testing.assert_allclose(routed["probs"].numpy(), np.asarray(jprobs),
                               atol=1e-6)
    assert torch.equal(keep, TL.moe_slots(top_e, m.e_pad)
                       < TL.moe_capacity(B * S, m))
    dropped = int((~keep).sum())
    if regime == "dropless":
        assert dropped == 0
    else:
        assert dropped > 0
    print(f"{arch} {regime}: dropped {dropped} of {keep.numel()}, smallest"
          f" top-k margin {_margin(routed['probs'], m.top_k):.3e}")


def test_moe_slots_and_capacity_follow_the_reference():
    """Slots count each expert's choices in token-major order; capacity is
    ceil(T·k/E·factor), at least 1: olmoe's batch-8 decode gets 2 slots
    per expert, so decode drops choices a forward keeps."""
    top_e = torch.tensor([[0, 2], [2, 0], [2, 1], [0, 2]])
    assert TL.moe_slots(top_e, 4).tolist() == [0, 0, 1, 1, 2, 0, 2, 3]
    # against the JAX package's formula (`layers.py:290-293`), on choices
    # of 8 distinct experts of 40 in a padded 48 per token
    rng = np.random.default_rng(0)
    top_e = np.stack([rng.permutation(40)[:8] for _ in range(300)])
    onehot = jax.nn.one_hot(top_e.reshape(-1), 48, dtype=jnp.int32)
    ref = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1
    np.testing.assert_array_equal(
        TL.moe_slots(torch.from_numpy(top_e), 48).numpy(), np.asarray(ref))
    olmoe = tconfigs.get_config("olmoe-1b-7b").moe
    assert TL.moe_capacity(8, olmoe) == 2
    assert TL.moe_capacity(1, olmoe) == 1
    assert TL.moe_capacity(4 * 4096, olmoe) == 2560
    granite = tconfigs.get_config("granite-moe-3b-a800m").moe
    assert TL.moe_capacity(512, granite) == int(np.ceil(512 * 8 / 40
                                                        * 1.25))


# ----------------------------------------------------------------- forward
@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_interpret"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax(arch, impl):
    """Logits and the aux loss summed over the layers, at the default
    capacity: both packages drop the same choices."""
    cfg = _cfg(arch)
    jparams, tparams = _params(cfg, seed=3)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (B, S))
    ref, ref_aux = jax_get_model(cfg).module.forward(
        jparams, {"tokens": jnp.asarray(tokens)}, cfg, return_aux=True)
    model = get_model(cfg.replace(attn_impl=impl))
    out, aux = model.module.forward(tparams,
                                    {"tokens": torch.from_numpy(tokens)},
                                    model.cfg, return_aux=True)
    assert out.shape == ref.shape and aux.shape == ()
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    assert float(aux) > 0
    torch.testing.assert_close(model.forward(
        tparams, {"tokens": torch.from_numpy(tokens)}), out, rtol=0, atol=0)


# ------------------------------------------------------------------ decode
def _decode(model, params, tokens):
    cache = model.init_cache(B, S, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = model.decode_step(
            params, cache, {"tokens": tokens[:, t:t + 1],
                            "pos": torch.full((B,), t, dtype=torch.int32)})
        outs.append(logits[:, 0])
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_matches_forward_when_dropless(arch):
    cfg = _dropless(arch)
    model = get_model(cfg)
    params = model.init(3, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (B, S)))
    full = model.forward(params, {"tokens": tokens})
    np.testing.assert_allclose(_np(_decode(model, params, tokens)),
                               _np(full), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_matches_jax_with_its_drops(arch):
    """At the default capacity a batch-2 decode step has 1 slot per
    expert: both packages drop the same choices, step by step, so decode
    differs from forward in both, and the port's decode equals JAX's."""
    cfg = _cfg(arch)
    jparams, tparams = _params(cfg, seed=5)
    jm, tm = jax_get_model(cfg), get_model(cfg)
    assert TL.moe_capacity(B, cfg.moe) == 1
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (B, S))
    jcache = jm.init_cache(B, S)
    step = jax.jit(jm.decode_step)
    ref = []
    for t in range(S):
        jl, jcache = step(jparams, jcache,
                          {"tokens": jnp.asarray(tokens[:, t:t + 1]),
                           "pos": jnp.full((B,), t, jnp.int32)})
        ref.append(np.asarray(jl[:, 0]))
    ours = _decode(tm, tparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(ours), np.stack(ref, axis=1), atol=TOL,
                               rtol=TOL)
    full = tm.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    assert (ours - full).abs().max() > 10 * TOL      # the drops show


# -------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def jax_steps():
    cache = {}

    def get(arch, k, cfg):
        if (arch, k) not in cache:
            model = jax_get_model(cfg)
            state = jax_init_state(model, jax.random.PRNGKey(0))
            host = jax.tree.map(np.asarray, state)
            step = jax.jit(jax_train_step(model, JHyper(
                adamw=JAdamW(**ADAMW), accum_steps=k)))
            new, metrics = step(state, _batch(cfg.vocab))
            cache[arch, k] = (host, jax.tree.map(np.asarray, new),
                              {n: float(v) for n, v in metrics.items()})
        return cache[arch, k]

    return get


def _padded_granite():
    """granite's smoke config with its published shape of padding: 8 real
    experts in a tree of 12 (the published config: 40 of 48)."""
    cfg = _cfg("granite-moe-3b-a800m")
    return cfg.replace(moe=dataclasses.replace(cfg.moe, padded_experts=12))


@pytest.mark.parametrize("arch,accum", [("olmoe-1b-7b", 1),
                                        ("olmoe-1b-7b", 2),
                                        ("granite-padded", 1)])
def test_moe_train_step_matches_jax(jax_steps, arch, accum):
    """Loss (ce + aux), its parts, grad norm, params and moments after one
    AdamW step; with accumulation each microbatch routes with its own
    capacity and aux, and the loss and grads are divided by k."""
    cfg = _padded_granite() if arch == "granite-padded" else _cfg(arch)
    host, jnew, jmetrics = jax_steps(arch, accum, cfg)
    step = make_train_step(get_model(cfg), TrainHyper(
        adamw=AdamWConfig(**ADAMW), accum_steps=accum))
    new, metrics = step(_to_port(host), {
        k: torch.from_numpy(v) for k, v in _batch(cfg.vocab).items()})
    assert metrics.keys() == jmetrics.keys()
    for name in jmetrics:
        np.testing.assert_allclose(float(metrics[name]), jmetrics[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    if accum == 1:
        assert metrics["aux"] > 0
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(metrics["ce"] + metrics["aux"]),
                                   rtol=1e-6)
    _close_trees(new["params"], jnew["params"], 2e-5)
    _close_trees(new["opt"].m, jnew["opt"].m, 1e-5)
    _close_trees(new["opt"].v, jnew["opt"].v, 1e-6)


def test_padded_experts_get_no_gradient_but_decay():
    """granite's dead experts: no token reaches them, so their gradients
    are 0; AdamW's weight decay still shrinks them, as in JAX."""
    cfg = _padded_granite()
    m = cfg.moe
    host = jax.tree.map(np.asarray,
                        jax_init_state(jax_get_model(cfg),
                                       jax.random.PRNGKey(0)))
    state = _to_port(host)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab).items()}
    _, _, grads = make_grad_fn(get_model(cfg))(state["params"], batch)
    for name in ("w_gate", "w_up", "w_down"):
        g = grads["layers"][name]
        assert not g[:, m.num_experts:].any(), name
        assert g[:, :m.num_experts].abs().amax(dim=(0, 2, 3)).min() > 0
    before = state["params"]["layers"]["w_up"][:, m.num_experts:].clone()
    new, metrics = make_train_step(get_model(cfg), TrainHyper(
        adamw=AdamWConfig(**ADAMW)))(state, batch)
    after = new["params"]["layers"]["w_up"][:, m.num_experts:]
    decay = 1 - float(metrics["lr"]) * AdamWConfig().weight_decay
    torch.testing.assert_close(after, before * decay, rtol=1e-6, atol=0)


# ------------------------------------------------------------------ counts
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(arch, size):
    get = tconfigs.get_config if size == "full" else \
        tconfigs.get_smoke_config
    jget = jax_config if size == "full" else jax_smoke_config
    ours, ref = get_model(get(arch)), jax_get_model(jget(arch))
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    assert ours.active_param_count() < ours.param_count()
    if (arch, size) == ("olmoe-1b-7b", "full"):
        assert ours.param_count() == 6_919_096_320


def test_train_launcher_trains_moe(capsys):
    """`python -m repro_torch.launch.train --arch olmoe-1b-7b --smoke
    --device cpu`: the MoE loss (ce + aux) through the WTF trainer."""
    from repro_torch.launch import train
    out = train.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                      "--steps", "3", "--batch", "4", "--seq", "16"])
    assert out["final_step"] == 3 and out["history"]   # step 1 is logged
    for h in out["history"]:
        assert h["aux"] > 0 and np.isfinite(h["loss"])
        np.testing.assert_allclose(h["loss"], h["ce"] + h["aux"], rtol=1e-6)
