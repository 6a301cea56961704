"""The port's xLSTM family (xlstm-1.3b) on the CPU against the JAX
package: the chunked and recurrent mLSTM, the sLSTM scan, the smoke
model's forward, stepped decode, greedy tokens, cache init and a JAX
cache continued by the port, and the train step's loss and gradients
(with accumulation, and remat "dots" against "none").  Same inputs (numpy,
from a seed), same params and caches (carried across with
`repro_torch.weights.from_numpy`), fp32 compute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import get_model as jax_get_model
from repro.models import xlstm as JX
from repro.train import AdamWConfig as JAdamW
from repro.train import TrainHyper as JHyper
from repro.train import init_state as jax_init_state
from repro.train import make_prefill_step as jax_prefill_step
from repro.train import make_serve_step as jax_serve_step
from repro.train import make_train_step as jax_train_step
from repro_torch import configs as tconfigs
from repro_torch.models import get_model
from repro_torch.models import xlstm as TX
from repro_torch.train import (AdamWConfig, OptState, TrainHyper,
                               make_grad_fn, make_prefill_step,
                               make_serve_step, make_train_step)
from repro_torch.weights import from_numpy

TOL = 2e-3          # decode against forward (test_decode_consistency.py)
B, S = 2, 16
ADAMW = dict(lr=1e-3, warmup_steps=5, decay_steps=100)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(ours, ref, atol=TOL, rtol=TOL):
    np.testing.assert_allclose(_np(ours), _np(ref), atol=atol, rtol=rtol)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _cfg():
    return tconfigs.get_smoke_config("xlstm-1.3b").replace(
        compute_dtype="float32", max_seq=S)


@pytest.fixture(scope="module")
def xlstm():
    cfg = _cfg()
    jparams = jax_get_model(cfg).init(jax.random.PRNGKey(3))
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.RandomState(4).randint(0, cfg.vocab, (B, S))
    return cfg, jparams, tparams, tokens.astype(np.int32)


def _mlstm_inputs(seed, b=2, s=128, h=2, dk=16, dv=32):
    """q, k, v, ig, fg, and a state (C, n, m), as numpy fp32 (the shapes
    of the JAX package's chunked-vs-recurrent test)."""
    rng = np.random.default_rng(seed)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa
    inputs = (mk(b, s, h, dk), mk(b, s, h, dk), mk(b, s, h, dv),
              mk(b, s, h), mk(b, s, h) + 2.0)
    state = (mk(b, h, dv, dk), np.abs(mk(b, h, dk)), mk(b, h))
    return inputs, state


# ------------------------------------------------------------------ mLSTM
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked_matches_jax(with_state):
    inputs, state = _mlstm_inputs(0)
    state = state if with_state else None
    ours, ost = TX.mlstm_chunked(
        *map(torch.from_numpy, inputs), chunk=32,
        state=None if state is None else tuple(map(torch.from_numpy, state)))
    ref, rst = JX.mlstm_chunked(
        *map(jnp.asarray, inputs), chunk=32,
        state=None if state is None else tuple(map(jnp.asarray, state)))
    # one algorithm in both: fp32 summation order only
    _close(ours, ref, 1e-5, 1e-4)
    for o, r in zip(ost, rst):
        _close(o, r, 1e-4, 1e-4)


def test_mlstm_chunked_matches_the_recurrent_form():
    """The port's chunked form against its own token-by-token `mlstm_step`,
    at the JAX package's tolerance for the same check (2e-4 / 2e-3)."""
    inputs, state = _mlstm_inputs(1)
    q, k, v, ig, fg = map(torch.from_numpy, inputs)
    out_c, st_c = TX.mlstm_chunked(q, k, v, ig, fg, chunk=32)
    b, _, h, dk = q.shape
    st = (torch.zeros(b, h, v.shape[-1], dk), torch.zeros(b, h, dk),
          torch.full((b, h), -float("inf")))
    outs = []
    for t in range(q.shape[1]):
        o, st = TX.mlstm_step(st, q[:, t], k[:, t], v[:, t], ig[:, t],
                              fg[:, t])
        outs.append(o)
    _close(out_c, torch.stack(outs, dim=1), 2e-4, 2e-3)
    # the carried state is the stepped one up to its stabiliser's shift
    scale = torch.exp(st_c[2] - st[2])[..., None]
    _close(st_c[1] * scale, st[1], 2e-4, 2e-3)


def test_mlstm_step_matches_jax():
    inputs, state = _mlstm_inputs(2, s=1)
    q, k, v, ig, fg = (x[:, 0] for x in inputs)
    for st in (state, (np.zeros_like(state[0]), np.zeros_like(state[1]),
                       np.full_like(state[2], -1e30))):
        ours, ost = TX.mlstm_step(tuple(map(torch.from_numpy, st)),
                                  *map(torch.from_numpy, (q, k, v, ig, fg)))
        ref, rst = JX.mlstm_step(tuple(map(jnp.asarray, st)),
                                 *map(jnp.asarray, (q, k, v, ig, fg)))
        _close(ours, ref, 1e-5, 1e-5)
        for o, r in zip(ost, rst):
            _close(o, r, 1e-5, 1e-5)


# ------------------------------------------------------------------ sLSTM
@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_matches_jax(xlstm, with_state):
    cfg, jparams, tparams, _ = xlstm
    jp = {k: v[0] for k, v in jparams["slstm"].items()}
    tp = {k: v[0] for k, v in tparams["slstm"].items()}
    rng = np.random.default_rng(5)
    y = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    dh = cfg.d_model // cfg.n_heads
    state = None
    if with_state:
        mk = lambda: rng.standard_normal((B, cfg.n_heads, dh)).astype(  # noqa
            np.float32)
        state = (mk(), np.abs(mk()) + 0.5, mk(), mk())
    ours, ost = TX.slstm_scan(
        tp, torch.from_numpy(y), cfg,
        state=None if state is None else tuple(map(torch.from_numpy, state)))
    ref, rst = JX.slstm_scan(
        jp, jnp.asarray(y), cfg,
        state=None if state is None else tuple(map(jnp.asarray, state)))
    _close(ours, ref, 1e-5, 1e-4)
    for o, r in zip(ost, rst):
        _close(o, r, 1e-5, 1e-4)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("seq", [S, 48])   # one chunk; three chunks of 16
def test_forward_matches_jax(xlstm, seq):
    cfg, jparams, tparams, _ = xlstm
    tokens = np.random.RandomState(6).randint(0, cfg.vocab, (B, seq))
    ref = jax_get_model(cfg).forward(jparams,
                                     {"tokens": jnp.asarray(tokens)})
    ours = get_model(cfg).forward(tparams,
                                  {"tokens": torch.from_numpy(tokens)})
    assert ours.shape == ref.shape == (B, seq, 512)
    _close(ours, ref, 2e-4, 2e-4)


def test_init_cache_matches_jax():
    cfg = _cfg()
    ours = _flat(get_model(cfg).init_cache(B, S, device="cpu"))
    ref = _flat(jax.tree.map(np.asarray, jax_get_model(cfg).init_cache(B,
                                                                       S)))
    assert ours.keys() == ref.keys()
    for name, leaf in ref.items():
        assert ours[name].dtype == torch.float32
        assert tuple(ours[name].shape) == leaf.shape
        np.testing.assert_array_equal(_np(ours[name]), leaf, err_msg=name)
    assert (ours["m_m"] == -1e30).all() and (ours["s_m"] == -1e30).all()
    assert (ours["s_n"] == np.float32(1e-6)).all()


def test_unknown_init_mode_raises():
    from repro_torch.models.common import P, init_params
    with pytest.raises(ValueError, match="unknown init mode"):
        init_params({"x": P((2,), (None,), init="neg_larg")}, None,
                    "float32", torch.device("cpu"))


def _step_batch(tokens, t, lib):
    return {"tokens": lib(tokens[:, t:t + 1]),
            "pos": lib(np.full((B,), t, np.int32))}


def test_decode_matches_forward_and_jax(xlstm):
    """Stepped decode equals the forward (the JAX package's decode
    property), and its logits and every cache leaf equal JAX's."""
    cfg, jparams, tparams, tokens = xlstm
    jm, tm = jax_get_model(cfg), get_model(cfg)
    full = tm.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    jcache = jm.init_cache(B, S)
    tcache = tm.init_cache(B, S, device="cpu")
    step = jax.jit(jm.decode_step)
    ours = []
    for t in range(S):
        jl, jcache = step(jparams, jcache, _step_batch(tokens, t,
                                                       jnp.asarray))
        tl, tcache = tm.decode_step(tparams, tcache,
                                    _step_batch(tokens, t, torch.from_numpy))
        _close(tl, jl, 1e-4, 1e-4)
        ours.append(tl[:, 0])
    _close(torch.stack(ours, dim=1), full)
    ref = _flat(jax.tree.map(np.asarray, jcache))
    for name, leaf in _flat(tcache).items():
        _close(leaf, ref[name], 1e-4, 1e-4)


def test_jax_cache_mid_decode_continues_in_the_port(xlstm):
    cfg, jparams, tparams, tokens = xlstm
    jm, tm = jax_get_model(cfg), get_model(cfg)
    step = jax.jit(jm.decode_step)
    jcache = jm.init_cache(B, S)
    for t in range(S // 2):
        _, jcache = step(jparams, jcache, _step_batch(tokens, t, jnp.asarray))
    tcache = from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    for t in range(S // 2, S):
        jl, jcache = step(jparams, jcache, _step_batch(tokens, t,
                                                       jnp.asarray))
        tl, tcache = tm.decode_step(tparams, tcache,
                                    _step_batch(tokens, t, torch.from_numpy))
        _close(tl, jl, 1e-4, 1e-4)


def _greedy(prefill, serve, params, cache, prompt, new, lib):
    first = [int(t) for t in prefill(params, {"tokens": lib(prompt)})]
    toks, out = prompt[:, :1], []
    for t in range(prompt.shape[1] + new - 1):
        nxt, cache = serve(params, cache,
                           {"tokens": lib(toks),
                            "pos": lib(np.full((len(prompt),), t,
                                               np.int32))})
        nxt = np.asarray(nxt).astype(np.int64)
        if t >= prompt.shape[1] - 1:
            out.append(nxt)
        toks = (prompt[:, t + 1:t + 2] if t + 1 < prompt.shape[1]
                else nxt[:, None])
    return first, np.stack(out, axis=1)


def test_greedy_tokens_match_jax(xlstm):
    cfg, jparams, tparams, tokens = xlstm
    prompt, new = tokens[:, :8], 8
    jm, tm = jax_get_model(cfg), get_model(cfg)
    ours = _greedy(make_prefill_step(tm), make_serve_step(tm), tparams,
                   tm.init_cache(B, S, device="cpu"), prompt, new,
                   torch.from_numpy)
    ref = _greedy(jax.jit(jax_prefill_step(jm)),
                  jax.jit(jax_serve_step(jm)), jparams,
                  jm.init_cache(B, S), prompt, new, jnp.asarray)
    assert ours[0] == ref[0]
    np.testing.assert_array_equal(ours[1], ref[1])
    assert ours[0] == list(ours[1][:, 0])


# ------------------------------------------------------------- train step
def _batch(vocab, seed=0, b=4, s=32):
    toks = np.random.RandomState(seed).randint(0, vocab, (b, s + 1))
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    cfg = _cfg()
    jmodel = jax_get_model(cfg)
    state = jax_init_state(jmodel, jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, state)
    batch = _batch(cfg.vocab)
    jnew, jmetrics = jax.jit(jax_train_step(jmodel, JHyper(
        adamw=JAdamW(**ADAMW), accum_steps=accum)))(state, batch)
    jnew = jax.tree.map(np.asarray, jnew)
    o = host["opt"]
    tstate = {"params": from_numpy(host["params"], "cpu"),
              "opt": OptState(from_numpy(o.m, "cpu"), from_numpy(o.v, "cpu"),
                              from_numpy(o.count, "cpu")),
              "step": from_numpy(host["step"], "cpu")}
    new, metrics = make_train_step(get_model(cfg), TrainHyper(
        adamw=AdamWConfig(**ADAMW), accum_steps=accum))(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert metrics.keys() == jmetrics.keys()
    for name in jmetrics:
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # the moments as in test_torch_train.py
    for mine, ref, tol in ((new["opt"].m, jnew["opt"].m, 1e-5),
                           (new["opt"].v, jnew["opt"].v, 1e-6)):
        ref = _flat(ref)
        for name, leaf in _flat(mine).items():
            _close(leaf, ref[name], tol, tol)
    # the first AdamW step moves a weight by lr·g/(|g| + eps); the gates'
    # saturated sigmoids leave gradients of ~1e-9, where the two
    # frameworks' rounding of g moves that ratio.  So the params are held
    # to test_torch_train.py's 2e-5 (a tenth of lr) where |g| ≥ 1e-6, a
    # hundred eps, and to lr (2e-4 here) below it
    ref = _flat(jnew["params"])
    grads = _flat(jnew["opt"].m)                 # m = (1 - b1)·g
    for name, leaf in _flat(new["params"]).items():
        diff = np.abs(_np(leaf) - ref[name])
        big = np.abs(grads[name]) >= 0.1 * 1e-6
        np.testing.assert_array_less(diff[big], 2e-5 + 2e-5
                                     * np.abs(ref[name][big]), name)
        np.testing.assert_array_less(diff, 2e-4, name)


class _CountBmm(TorchDispatchMode):
    """Counts `aten.bmm` calls (the chunk einsums' products)."""
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.bmm.default
        return func(*args, **(kwargs or {}))


def test_remat_dots_keeps_the_chunk_products():
    """remat "dots" (the published config's) gives the gradients of
    "none" and keeps every bmm output: its backward runs no more bmm than
    "none"'s, where "full" recomputes them."""
    cfg = _cfg()
    params = get_model(cfg).init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(cfg.vocab, b=2, s=32).items()}
    grads, counts = {}, {}
    for remat in ("none", "dots", "full"):
        with _CountBmm() as mode:
            grads[remat] = _flat(make_grad_fn(get_model(cfg.replace(
                remat=remat)))(params, batch)[2])
        counts[remat] = mode.n
    assert counts["dots"] == counts["none"] < counts["full"]
    for remat in ("dots", "full"):
        for name, g in grads["none"].items():
            np.testing.assert_allclose(_np(grads[remat][name]), _np(g),
                                       atol=1e-6, rtol=1e-5, err_msg=name)


# ------------------------------------------------------- entry points, CPU
def _decode_example():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" \
        / "torch_decode_lm.py"
    spec = importlib.util.spec_from_file_location("torch_decode_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_decode_example_runs_on_the_cpu(capsys):
    """`examples/torch_decode_lm.py --arch xlstm-1.3b --device cpu`: the
    prefill's token is the decode path's first (the example checks)."""
    tokens = _decode_example().main(["--arch", "xlstm-1.3b", "--device",
                                     "cpu", "--max-new", "4"])
    assert tokens.shape == (4, 4)
    assert int(tokens.min()) >= 0 and int(tokens.max()) < 512
    assert "xlstm-1.3b: batch 4" in capsys.readouterr().out


def test_train_launcher_trains_xlstm():
    """`python -m repro_torch.launch.train --arch xlstm-1.3b --smoke
    --device cpu`: the WTF trainer over the xLSTM step."""
    from repro_torch.launch import train
    out = train.main(["--arch", "xlstm-1.3b", "--smoke", "--device", "cpu",
                      "--steps", "3", "--batch", "4", "--seq", "16"])
    assert out["final_step"] == 3 and out["history"]
    assert all(np.isfinite(h["loss"]) for h in out["history"])


def test_den_log_records_each_chunks_floor_margin():
    """`xlstm.DEN_LOG`, while a list, gets one [B, Q, H] margin per chunk,
    (|den| - exp(-m)) / exp(-m); a margin ≤ 0 is a position on the floor.
    None (the default) records nothing and leaves the output as it is."""
    inputs, _ = _mlstm_inputs(3)
    args = [torch.from_numpy(a) for a in inputs]
    ref, _ = TX.mlstm_chunked(*args, chunk=32)
    assert TX.DEN_LOG is None
    TX.DEN_LOG = []
    try:
        out, _ = TX.mlstm_chunked(*args, chunk=32)
        log = TX.DEN_LOG
    finally:
        TX.DEN_LOG = None
    assert torch.equal(out, ref)
    assert len(log) == 4 and all(m.shape == (2, 32, 2) for m in log)
    margins = torch.cat(log, dim=1)
    assert (margins > -1).all()                  # |den| ≥ 0
    assert 0 < int((margins <= 0).sum()) < margins.numel()
