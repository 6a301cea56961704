"""The port's training half on the CPU against the JAX package: the loss,
AdamW, the train step (with gradient accumulation) for smoke smollm-360m,
qwen2-7b and zamba2-1.2b, the remat policies, the flash op's gradient, and
the SSD-scan op's gradient through its autograd Function.  Same inputs
(numpy, from a seed) and same params and optimizer state (JAX
`init_state`, carried across with `repro_torch.weights.from_numpy`), fp32
compute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro.models import mamba2 as JM
from repro.train import AdamWConfig as JAdamW
from repro.train import TrainHyper as JHyper
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_train_step
from repro.train import optimizer as JO
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.models import dense as TD
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.train import (AdamWConfig, OptState, TrainHyper, init_state,
                               make_grad_fn, make_loss_fn, make_train_step)
from repro_torch.train import optimizer as TO
from repro_torch.weights import from_numpy

ARCHS = ["smollm-360m", "qwen2-7b", "zamba2-1.2b"]
B, S = 4, 32
ADAMW = dict(lr=1e-3, warmup_steps=5, decay_steps=100)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _close_trees(ours, ref, tol):
    ours, ref = _flat(ours), _flat(ref)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(_np(ours[k]), _np(ref[k]), atol=tol,
                                   rtol=tol, err_msg=k)


def _to_port(state) -> dict:
    """A JAX train state (numpy leaves) as the port's state on the CPU."""
    o = state["opt"]
    return {"params": from_numpy(state["params"], "cpu"),
            "opt": OptState(from_numpy(o.m, "cpu"), from_numpy(o.v, "cpu"),
                            from_numpy(o.count, "cpu")),
            "step": from_numpy(state["step"], "cpu")}


def _fp32(arch, **kw):
    return (jax_smoke_config(arch).replace(compute_dtype="float32", **kw),
            get_smoke_config(arch).replace(compute_dtype="float32", **kw))


def _batch(vocab, seed=0, b=B, s=S):
    toks = np.random.RandomState(seed).randint(0, vocab, (b, s + 1))
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------------- loss
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(dtype):
    rng = np.random.default_rng(0)
    logits = (4 * rng.standard_normal((2, 7, 384))).astype(np.float32)
    labels = rng.integers(0, 384, (2, 7)).astype(np.int32)
    ref = JL.cross_entropy(jnp.asarray(logits).astype(dtype),
                           jnp.asarray(labels))
    ours = TL.cross_entropy(torch.from_numpy(logits).to(getattr(torch,
                                                                dtype)),
                            torch.from_numpy(labels))
    assert ours.dtype == torch.float32 and ours.shape == ()
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


# -------------------------------------------------------------- optimizer
def _opt_inputs(seed, grad_scale):
    """Params, grads, m and v as numpy trees with leaves of 1, 2 and 3
    dims: a norm, a matrix, a stacked matrix and a stacked norm."""
    rng = np.random.default_rng(seed)

    def tree(scale=1.0):
        mk = lambda *s: scale * rng.standard_normal(s).astype(  # noqa
            np.float32)
        return {"ln": mk(6), "w": mk(6, 5),
                "layers": {"wq": mk(2, 6, 5), "ln": mk(2, 6)}}

    params, grads, m = tree(), tree(grad_scale), tree()
    v = jax.tree.map(np.abs, tree())
    return params, grads, m, v


@pytest.mark.parametrize("case,count,grad_scale,clip", [
    ("first step", 0, 0.1, 1.0),
    ("clipped", 3, 10.0, 1.0),
    ("past warmup", 300, 0.1, 1.0),
    ("no clip", 50, 10.0, None),
])
def test_optimizer_update_matches_jax(case, count, grad_scale, clip):
    cfg = dict(lr=3e-4, warmup_steps=100, decay_steps=1000, grad_clip=clip)
    params, grads, m, v = _opt_inputs(count, grad_scale)
    jstate = JO.OptState(jax.tree.map(jnp.asarray, m),
                         jax.tree.map(jnp.asarray, v),
                         jnp.asarray(count, jnp.int32))
    jp, js, jm = JO.update(JO.AdamWConfig(**cfg),
                           jax.tree.map(jnp.asarray, grads), jstate,
                           jax.tree.map(jnp.asarray, params))
    tstate = OptState(from_numpy(m, "cpu"), from_numpy(v, "cpu"),
                      torch.tensor(count, dtype=torch.int32))
    tp, ts, tm = TO.update(AdamWConfig(**cfg), from_numpy(grads, "cpu"),
                           tstate, from_numpy(params, "cpu"))
    if case == "clipped":
        assert float(jm["grad_norm"]) > 1.0
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(ts.count) == int(js.count) == count + 1
    assert ts.count.dtype == torch.int32 and ts.count.shape == ()
    for ours, ref in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        _close_trees(ours, jax.tree.map(np.asarray, ref), 1e-6)


def test_optimizer_decays_every_leaf_of_two_dims_or_more():
    """As the JAX package's code does (`optimizer.py:79-80`): the stacked
    [L, d] norm decays, the unstacked [d] one does not."""
    params = {"ln": np.ones(4, np.float32),
              "layers": {"ln": np.ones((2, 4), np.float32)}}
    zeros = {"ln": np.zeros(4, np.float32),
             "layers": {"ln": np.zeros((2, 4), np.float32)}}
    cfg = AdamWConfig(lr=1.0, warmup_steps=0, weight_decay=0.5)
    p, _, _ = TO.update(cfg, from_numpy(zeros, "cpu"),
                        TO.init(from_numpy(params, "cpu")),
                        from_numpy(params, "cpu"))
    assert torch.equal(p["ln"], torch.ones(4))
    assert torch.allclose(p["layers"]["ln"], torch.full((2, 4), 0.5))


def test_schedule_matches_jax():
    cfg = dict(lr=1e-3, warmup_steps=20, decay_steps=250, min_lr_ratio=0.1)
    steps = np.arange(0, 301, dtype=np.int32)
    ref = JO.schedule(JO.AdamWConfig(**cfg), jnp.asarray(steps))
    ours = TO.schedule(AdamWConfig(**cfg), torch.from_numpy(steps))
    np.testing.assert_allclose(_np(ours), np.asarray(ref), rtol=1e-6,
                               atol=1e-12)


# ------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def jax_steps():
    """One JAX `make_train_step` per (arch, accum) from `init_state`."""
    cache = {}

    def get(arch, k):
        if (arch, k) not in cache:
            jcfg, _ = _fp32(arch)
            model = jax_get_model(jcfg)
            state = jax_init_state(model, jax.random.PRNGKey(0))
            host = jax.tree.map(np.asarray, state)
            step = jax.jit(jax_train_step(model, JHyper(
                adamw=JAdamW(**ADAMW), accum_steps=k)))
            new, metrics = step(state, _batch(jcfg.vocab))
            cache[arch, k] = (host, jax.tree.map(np.asarray, new),
                              {n: float(v) for n, v in metrics.items()})
        return cache[arch, k]

    return get


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(jax_steps, arch, accum):
    host, jnew, jmetrics = jax_steps(arch, accum)
    _, cfg = _fp32(arch)
    step = make_train_step(get_model(cfg), TrainHyper(
        adamw=AdamWConfig(**ADAMW), accum_steps=accum))
    state = _to_port(host)
    new, metrics = step(state, _tbatch(_batch(cfg.vocab)))
    # the metrics JAX reports: ce and aux only without accumulation
    assert metrics.keys() == jmetrics.keys()
    for name in jmetrics:
        np.testing.assert_allclose(float(metrics[name]), jmetrics[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert int(new["step"]) == 1 and int(new["opt"].count) == 1
    # the first AdamW step moves each weight by lr·g/(|g| + eps) ≈ ±lr;
    # where |g| is near eps the two frameworks' fp32 rounding of g moves
    # that ratio, so the params agree to a tenth of lr (lr = 2e-4 here)
    _close_trees(new["params"], jnew["params"], 2e-5)
    _close_trees(new["opt"].m, jnew["opt"].m, 1e-5)
    _close_trees(new["opt"].v, jnew["opt"].v, 1e-6)


def test_init_state_on_the_asked_device():
    model = get_model(get_smoke_config("smollm-360m"))
    state = init_state(model, 0, device="cpu")
    assert set(state) == {"params", "opt", "step"}
    assert isinstance(state["opt"], OptState)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    assert state["opt"].count.dtype == torch.int32
    flat = _flat(state["params"])
    assert _flat(state["opt"].m).keys() == flat.keys()
    assert all(t.dtype == torch.float32 for t in flat.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_state(model, 0)


def test_loss_fn_refuses_moe_until_its_slice():
    model = get_model(get_smoke_config("smollm-360m"))
    moe = type(model)(jax_smoke_config("olmoe-1b-7b"), model.module)
    with pytest.raises(NotImplementedError, match="MoE slice"):
        make_loss_fn(moe)


# ------------------------------------------------------------------ remat
def _grads(cfg, params, batch):
    """{path: gradient} of the loss at ``params``."""
    return _flat(make_grad_fn(get_model(cfg))(params, batch)[2])


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-1.2b"])
def test_remat_gives_the_same_gradients(arch, remat, monkeypatch):
    _, cfg = _fp32(arch)
    params = get_model(cfg).init(0, device="cpu")
    batch = _tbatch(_batch(cfg.vocab, b=2, s=16))
    ref = _grads(cfg, params, batch)
    # each layer's body runs once more in backward under remat
    module, name = (TD, "_block") if arch != "zamba2-1.2b" \
        else (TM, "mamba2_block")
    calls = []
    inner = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    ours = _grads(cfg.replace(remat=remat), params, batch)
    assert len(calls) == 2 * cfg.n_layers
    for k in ref:
        np.testing.assert_allclose(_np(ours[k]), _np(ref[k]), atol=1e-6,
                                   rtol=1e-5, err_msg=k)
    calls.clear()
    with torch.no_grad():
        get_model(cfg.replace(remat=remat)).forward(params, batch)
    assert len(calls) == cfg.n_layers


# ---------------------------------------------------------- flash gradient
@pytest.mark.parametrize("impl", ["pallas", "pallas_interpret"])
def test_flash_paths_give_the_xla_gradients(impl):
    """The kernel op (its plain version on a CPU tensor, backward through
    the plain recompute) and the plain path give the einsum path's
    gradients, and both give JAX's."""
    jcfg, cfg = _fp32("smollm-360m")
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(1))
    params = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    batch = _batch(cfg.vocab, b=2, s=16)
    ref = _grads(cfg, params, _tbatch(batch))
    ours = _grads(cfg.replace(attn_impl=impl), params, _tbatch(batch))
    for k in ref:
        np.testing.assert_allclose(_np(ours[k]), _np(ref[k]), atol=1e-6,
                                   rtol=1e-5, err_msg=k)

    def jloss(p):
        logits = jax_get_model(jcfg).module.forward(p, batch, jcfg)
        return JL.cross_entropy(logits, batch["labels"])

    jgrads = _flat(jax.tree.map(np.asarray, jax.grad(jloss)(jparams)))
    for k in jgrads:
        np.testing.assert_allclose(_np(ours[k]), jgrads[k], atol=1e-5,
                                   rtol=1e-4, err_msg=k)


# ------------------------------------------------- SSD-scan op's gradient
def _ssd_args(seed=0, b=2, s=32, h=3, p=8, n=4):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa
    dt = np.log1p(np.exp(mk(b, s, h))).astype(np.float32)
    return dict(xh=mk(b, s, h, p), dt=dt, a_log=0.5 * mk(h), b=mk(b, s, n),
                c=mk(b, s, n), d_skip=mk(h)), (mk(b, s, h, p),
                                               mk(b, h, p, n), mk(b, h, p, n))


def _graph_nodes(fn):
    seen, todo = set(), [fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(nxt for nxt, _ in node.next_functions)
    return {type(n).__name__ for n in seen}


def test_ssd_op_runs_the_scan_through_its_autograd_function():
    args, _ = _ssd_args()
    targs = {k: torch.from_numpy(v).requires_grad_() for k, v in
             args.items()}
    y, s_final = ssd_ops.ssd_scan(**targs, chunk=16)
    assert "_SSDScanBackward" in _graph_nodes(y.grad_fn)
    assert type(s_final.grad_fn).__name__ == "_SSDScanBackward"
    # params without requires_grad (serving) build no graph
    y, s_final = ssd_ops.ssd_scan(**{k: t.detach() for k, t in
                                     targs.items()}, chunk=16)
    assert y.grad_fn is None and s_final.grad_fn is None


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("s,chunk", [(32, 16), (12, 16)])
def test_ssd_op_gradients_match_jax(s, chunk, with_s0):
    """Gradients of Σ y·wy + Σ s_final·ws with respect to every input of
    the op against `jax.grad` through the JAX package's `ssd_chunked`
    (`models/mamba2.py:227`), within the reference's SSD tolerance."""
    args, (wy, ws, s0) = _ssd_args(seed=s, s=s)
    if with_s0:
        args["s0"] = s0
    names = list(args)

    def jloss(*vals):
        kw = dict(zip(names, vals))
        s0_ = kw.pop("s0", None)
        y, sf = JM.ssd_chunked(**kw, chunk=chunk, s0=s0_)
        return jnp.sum(y * wy) + jnp.sum(sf * ws)

    jgrads = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *[jnp.asarray(args[k]) for k in names])
    targs = {k: torch.from_numpy(v).requires_grad_() for k, v in
             args.items()}
    y, sf = TM.ssd_chunked(**targs, chunk=chunk)
    loss = (y * torch.from_numpy(wy)).sum() + (sf * torch.from_numpy(ws)
                                               ).sum()
    tgrads = torch.autograd.grad(loss, [targs[k] for k in names])
    for name, ours, ref in zip(names, tgrads, jgrads):
        np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=2e-3,
                                   rtol=2e-3, err_msg=name)
