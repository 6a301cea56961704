"""The port's Whisper family (whisper-medium) on the CPU against the JAX
package: layer_norm, the tanh-form GELU MLP, the sinusoidal positions,
the encoder (einsum path, and the flash kernel's plain version against
the Pallas kernel in interpret mode, non-causal), the cross-attention
K/V, the smoke model's forward, stepped decode with the cross cache,
cache init and a JAX cache continued by the port, and the
train step's loss and gradients (with accumulation).  Same inputs (numpy,
from a seed), same params and caches (carried across with
`repro_torch.weights.from_numpy`), fp32 compute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro.models import whisper as JW
from repro.train import AdamWConfig as JAdamW
from repro.train import TrainHyper as JHyper
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_train_step
from repro_torch import configs as tconfigs
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.models import whisper as TW
from repro_torch.train import (AdamWConfig, OptState, TrainHyper,
                               make_train_step)
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


def _cfg(**kw):
    return tconfigs.get_smoke_config("whisper-medium").replace(
        compute_dtype="float32", max_seq=S, **kw)


@pytest.fixture(scope="module")
def whisper():
    cfg = _cfg()
    jparams = jax_get_model(cfg).init(jax.random.PRNGKey(3))
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = rng.standard_normal(
        (B, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32)
    return cfg, jparams, tparams, tokens, frames


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 1e-2)])
def test_layer_norm_matches_jax(dtype, tol):
    """bf16: normalised in fp32, cast, then scaled and shifted in bf16, as
    JAX does; one bf16 rounding apart at most."""
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 5, 64)) + 1).astype(np.float32)
    scale, bias = rng.standard_normal((2, 64)).astype(np.float32)
    tdt = getattr(torch, dtype)
    ours = TL.layer_norm(*(torch.from_numpy(a).to(tdt)
                           for a in (x, scale, bias)), 1e-5)
    ref = JL.layer_norm(*(jnp.asarray(a).astype(dtype)
                          for a in (x, scale, bias)), 1e-5)
    assert ours.dtype == tdt
    _close(ours, ref, tol, tol)


def test_gelu_mlp_matches_jax_tanh_form():
    """`jax.nn.gelu` is the tanh approximation; at these inputs exact-erf
    GELU misses the reference by more than the 1e-5 tolerance."""
    cfg = _cfg()
    params = jax_get_model(cfg).init(jax.random.PRNGKey(1))
    lp = {k: v[0] for k, v in params["encoder"].items()}
    jp = {"ln": lp["mlp_ln"], "ln_b": lp["mlp_ln_b"], "w_up": lp["w_up"],
          "b_up": lp["b_up"] + 0.5, "w_down": lp["w_down"],
          "b_down": lp["b_down"] + 0.1}
    tp = from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(2).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    ref = JL.gelu_mlp(jp, jnp.asarray(x), cfg)
    _close(TL.gelu_mlp(tp, torch.from_numpy(x), cfg), ref, 1e-5, 1e-5)
    # the same MLP with exact-erf GELU is off by more than the tolerance
    y = TL.layer_norm(torch.from_numpy(x), tp["ln"], tp["ln_b"],
                      cfg.norm_eps)
    erf = F.gelu(y @ tp["w_up"] + tp["b_up"]) @ tp["w_down"] + tp["b_down"]
    assert np.abs(_np(erf) - _np(ref)).max() > 1e-4


def test_sinusoids_match_jax():
    for length, ch in ((30, 64), (1500, 1024)):
        ours = TW.sinusoids(length, ch)
        assert ours.dtype == np.float64
        np.testing.assert_array_equal(ours, JW.sinusoids(length, ch))


# ---------------------------------------------------------------- encoder
@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_interpret"])
def test_encode_matches_jax(whisper, impl):
    """The encoder's non-causal self-attention: einsum path against JAX's;
    the flash op's plain version (pallas on a CPU tensor, and
    pallas_interpret) against JAX's Pallas kernel in interpret mode."""
    cfg, jparams, tparams, _, frames = whisper
    jimpl = "xla" if impl == "xla" else "pallas_interpret"
    ref = JW.encode(jparams, jnp.asarray(frames), cfg.replace(
        attn_impl=jimpl))
    ours = TW.encode(tparams, torch.from_numpy(frames),
                     cfg.replace(attn_impl=impl))
    assert ours.shape == (B, cfg.encdec.encoder_seq, cfg.d_model)
    _close(ours, ref, 1e-5, 1e-5)


def test_make_cross_kv_matches_jax(whisper):
    cfg, jparams, tparams, _, frames = whisper
    enc = np.array(JW.encode(jparams, jnp.asarray(frames), cfg))
    ref = JW.make_cross_kv(jparams, jnp.asarray(enc), cfg)
    ours = TW.make_cross_kv(tparams, torch.from_numpy(enc), cfg)
    for name in ("k", "v"):
        assert ours[name].shape == (cfg.n_layers, B, cfg.encdec.encoder_seq,
                                    cfg.n_kv_heads, cfg.head_dim_)
        _close(ours[name], ref[name], 1e-5, 1e-5)


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_interpret"])
def test_forward_matches_jax(whisper, impl):
    cfg, jparams, tparams, tokens, frames = whisper
    ref = jax_get_model(cfg).forward(
        jparams, {"frames": jnp.asarray(frames),
                  "tokens": jnp.asarray(tokens)})
    ours = get_model(cfg.replace(attn_impl=impl)).forward(
        tparams, {"frames": torch.from_numpy(frames),
                  "tokens": torch.from_numpy(tokens)})
    assert ours.shape == ref.shape == (B, S, 512)
    _close(ours, ref, 2e-4, 2e-4)


def test_init_cache_matches_jax():
    cfg = _cfg()
    ours = _flat(get_model(cfg).init_cache(B, S, device="cpu"))
    ref = _flat(jax.tree.map(np.asarray,
                             jax_get_model(cfg).init_cache(B, S)))
    assert ours.keys() == ref.keys() == {
        "self/k", "self/v", "self/key_pos", "cross/k", "cross/v"}
    for name, leaf in ref.items():
        assert tuple(ours[name].shape) == leaf.shape
        np.testing.assert_array_equal(_np(ours[name]), leaf, err_msg=name)
    assert ours["self/key_pos"].dtype == torch.int32


def _step_batch(tokens, t, lib):
    return {"tokens": lib(tokens[:, t:t + 1]),
            "pos": lib(np.full((B,), t, np.int32))}


def _caches(cfg, jparams, tparams, frames):
    """A fresh JAX and port cache, each with its package's cross K/V."""
    jm, tm = jax_get_model(cfg), get_model(cfg)
    jcache = jm.init_cache(B, S)
    jcache["cross"] = JW.make_cross_kv(
        jparams, JW.encode(jparams, jnp.asarray(frames), cfg), cfg)
    tcache = tm.init_cache(B, S, device="cpu")
    tcache["cross"] = TW.make_cross_kv(
        tparams, TW.encode(tparams, torch.from_numpy(frames), cfg), cfg)
    return jcache, tcache


def test_decode_matches_forward_and_jax(whisper):
    """Stepped decode with the cross cache equals the forward, and its
    logits and caches equal JAX's."""
    cfg, jparams, tparams, tokens, frames = whisper
    jm, tm = jax_get_model(cfg), get_model(cfg)
    full = tm.forward(tparams, {"frames": torch.from_numpy(frames),
                                "tokens": torch.from_numpy(tokens)})
    jcache, tcache = _caches(cfg, jparams, tparams, frames)
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
        _close(leaf, ref[name], 1e-5, 1e-5)
    assert int(tcache["self"]["key_pos"].max()) == S - 1


def test_jax_cache_mid_decode_continues_in_the_port(whisper):
    cfg, jparams, tparams, tokens, frames = whisper
    jm, tm = jax_get_model(cfg), get_model(cfg)
    step = jax.jit(jm.decode_step)
    jcache, _ = _caches(cfg, jparams, tparams, frames)
    for t in range(S // 2):
        _, jcache = step(jparams, jcache, _step_batch(tokens, t, jnp.asarray))
    tcache = from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    assert tcache["self"]["key_pos"].dtype == torch.int32
    for t in range(S // 2, S):
        jl, jcache = step(jparams, jcache, _step_batch(tokens, t,
                                                       jnp.asarray))
        tl, tcache = tm.decode_step(tparams, tcache,
                                    _step_batch(tokens, t, torch.from_numpy))
        _close(tl, jl, 1e-4, 1e-4)
    # the port's cache now holds what JAX's holds
    ref = _flat(jax.tree.map(np.asarray, jcache))
    for name, leaf in _flat(tcache).items():
        _close(leaf, ref[name], 1e-5, 1e-5)


# ------------------------------------------------------------- train step
def _batch(cfg, seed=0, b=4, s=S - 1):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    frames = rng.standard_normal(
        (b, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32)
    return {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    """Loss, moments and params after one step; the accumulation splits
    ``frames`` [B, 30, d] along the batch with the tokens."""
    cfg = _cfg()
    jmodel = jax_get_model(cfg)
    state = jax_init_state(jmodel, jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, state)
    batch = _batch(cfg)
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
    # as in test_torch_train.py
    for mine, ref, tol in ((new["params"], jnew["params"], 2e-5),
                           (new["opt"].m, jnew["opt"].m, 1e-5),
                           (new["opt"].v, jnew["opt"].v, 1e-6)):
        ref = _flat(ref)
        for name, leaf in _flat(mine).items():
            _close(leaf, ref[name], tol, tol)


def test_decode_example_runs_on_the_cpu(capsys):
    """`examples/torch_decode_lm.py --arch whisper-medium --device cpu`:
    encode, the cross K/V, then greedy decode."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" \
        / "torch_decode_lm.py"
    spec = importlib.util.spec_from_file_location("torch_decode_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    tokens = mod.main(["--arch", "whisper-medium", "--device", "cpu",
                       "--max-new", "4"])
    assert tokens.shape == (4, 4)
    assert int(tokens.min()) >= 0 and int(tokens.max()) < 512
    assert "whisper-medium: batch 4" in capsys.readouterr().out
