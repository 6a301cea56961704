"""The port's Mamba2 slice on the CPU against the JAX package: the SSD scan
(plain version against the Pallas kernel in interpret mode and the
recurrent oracle), the Mamba2 block, the ring-cache decode attention, and
zamba2 smoke forward and decode (logits, caches, greedy tokens), on the
same inputs made with numpy from a seed and the same params and caches,
carried across with `repro_torch.weights.from_numpy`.  The CUDA kernel
itself runs only on the card: ``chip_smoke.py`` holds it against the plain
version there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_scan import ssd_recurrent_ref as jax_recurrent
from repro.kernels.mamba2_scan import ssd_scan as jax_ssd_scan
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro.models import mamba2 as JM
from repro.train import make_prefill_step as jax_prefill_step
from repro.train import make_serve_step as jax_serve_step
from repro_torch import configs as tconfigs
from repro_torch.kernels import _build
from repro_torch.kernels.mamba2_scan import (ssd_recurrent_ref, ssd_scan,
                                             ssd_scan_plain)
from repro_torch.kernels.mamba2_scan.kernel import plan as ssd_plan
from repro_torch.kernels.mamba2_scan.kernel import ssd_scan_fwd
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.train import make_prefill_step, make_serve_step
from repro_torch.weights import from_numpy

TOL = 2e-3          # the reference's own SSD tolerance (test_kernels.py)
B, S = 2, 16        # decode-consistency sizes of the JAX package's test


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(ours, ref, tol=TOL):
    np.testing.assert_allclose(_np(ours), _np(ref), atol=tol, rtol=tol)


def _ssd_inputs(b, s, h, p, n, seed=0, dt_scale=1.0):
    """xh, dt (post-softplus), a_log, b, c, d_skip as numpy fp32."""
    rng = np.random.default_rng(seed)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa
    dt = np.log1p(np.exp(mk(b, s, h))) * dt_scale
    return (mk(b, s, h, p), dt.astype(np.float32), 0.5 * mk(h),
            mk(b, s, n), mk(b, s, n), mk(h))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------- SSD scan
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 256, 4, 64, 32, 64),
    (1, 128, 2, 64, 64, 128),
    (2, 512, 8, 32, 16, 64),
])
def test_ssd_scan_plain_matches_jax(b, s, h, p, n, chunk):
    args = _ssd_inputs(b, s, h, p, n)
    y, sf = ssd_scan(*_t(*args), chunk=chunk)
    yk, sk = jax_ssd_scan(*_j(*args), chunk=chunk, interpret=True)
    _close(y, yk)
    _close(sf, sk)
    xh, dt, a_log, bb, cc, d_skip = args
    xw, dta = xh * dt[..., None], dt * -np.exp(a_log)
    yr, sr = jax_recurrent(*_j(xw, dta, bb, cc))
    _close(y, np.asarray(yr) + d_skip[:, None] * xh)
    _close(sf, sr)
    # the port's copy of the oracle is the JAX one
    yo, so = ssd_recurrent_ref(*_t(xw, dta, bb, cc))
    _close(yo, yr, 1e-4)
    _close(so, sr, 1e-4)


def test_ssd_scan_plain_takes_an_initial_state():
    b, s, h, p, n, chunk = 2, 96, 3, 16, 8, 32
    xh, dt, a_log, bb, cc, _ = _ssd_inputs(b, s, h, p, n, seed=1)
    s0 = np.random.default_rng(2).standard_normal(
        (b, h, p, n)).astype(np.float32)
    xw, dta = xh * dt[..., None], dt * -np.exp(a_log)
    y, sf = ssd_scan_plain(*_t(xw.transpose(0, 2, 1, 3),
                              dta.transpose(0, 2, 1), bb, cc),
                           chunk=chunk, s0=torch.from_numpy(s0))
    yr, sr = jax_recurrent(*_j(xw, dta, bb, cc, s0))
    _close(y.transpose(1, 2), yr)
    _close(sf, sr)


def test_ssd_scan_plain_masks_before_the_exponent():
    """With a large dt, exp(l_i − l_j) above the diagonal overflows; the
    plain version masks first, so its output stays finite and right."""
    b, s, h, p, n, chunk = 1, 128, 2, 16, 8, 128
    args = list(_ssd_inputs(b, s, h, p, n, seed=3, dt_scale=40.0))
    args[2] = np.full((h,), 1.0, np.float32)          # A = -e
    xh, dt, a_log, bb, cc, d_skip = args
    dta = dt * -np.exp(a_log)
    assert -dta.sum(axis=1).max() > 89               # exp(>88.7) is inf
    y, sf = ssd_scan(*_t(*args), chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(sf).all()
    yr, sr = jax_recurrent(*_j(xh * dt[..., None], dta, bb, cc))
    _close(y, np.asarray(yr) + d_skip[:, None] * xh)
    _close(sf, sr)


@pytest.mark.parametrize("s,chunk", [(16, 16), (12, 16), (64, 16)])
@pytest.mark.parametrize("with_s0", [False, True])
def test_ssd_chunked_matches_jax(s, chunk, with_s0):
    b, h, p, n = 2, 4, 16, 8
    args = _ssd_inputs(b, s, h, p, n, seed=4)
    s0 = (np.random.default_rng(5).standard_normal((b, h, p, n))
          .astype(np.float32) if with_s0 else None)
    y, sf = TM.ssd_chunked(*_t(*args), chunk=chunk,
                           s0=None if s0 is None else torch.from_numpy(s0))
    yj, sj = JM.ssd_chunked(*_j(*args), chunk,
                            s0=None if s0 is None else jnp.asarray(s0))
    _close(y, yj)
    _close(sf, sj)


def test_ssd_chunked_refuses_a_ragged_sequence():
    args = _ssd_inputs(1, 24, 2, 8, 4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        TM.ssd_chunked(*_t(*args), chunk=16)
    with pytest.raises(AssertionError):
        JM.ssd_chunked(*_j(*args), 16)


def test_ssd_step_matches_jax():
    rng = np.random.default_rng(6)
    b, h, p, n = 3, 4, 8, 6
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa
    args = (mk(b, h, p, n), mk(b, h, p), np.abs(mk(b, h)), mk(h), mk(b, n),
            mk(b, n), mk(h))
    for ours, ref in zip(TM.ssd_step(*_t(*args)), JM.ssd_step(*_j(*args))):
        _close(ours, ref, 1e-5)


# ------------------------------------------------------ the kernel wrapper
def test_ssd_kernel_wrapper_refuses_cpu_tensors():
    xw, dta = torch.zeros(1, 2, 32, 16), torch.zeros(1, 2, 32)
    bc = torch.zeros(1, 32, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_fwd(xw, dta, bc, bc, chunk=16)
    src = (_build.CSRC / "mamba2_scan.cu").read_text()
    assert "int ssd_scan_fwd(" in src and "repro_error_string" in src
    assert "src/repro/kernels/mamba2_scan/kernel.py" in src


@pytest.mark.parametrize("b,h,s,p,n,chunk,tile,nc", [
    (4, 64, 4096, 64, 64, 128, 64, 32),     # zamba2-1.2b prefill
    (2, 8, 64, 16, 16, 16, 16, 4),          # smoke sizes
    (2, 8, 64, 64, 64, 128, 64, 1),         # S < chunk: one chunk of S
    (1, 3, 200, 40, 24, 100, 64, 2),        # ragged widths, padded
    (1, 2, 96, 32, 8, 32, 32, 3),
])
def test_ssd_plan_sizes_the_scratch(b, h, s, p, n, chunk, tile, nc):
    pl = ssd_plan(b, h, s, p, n, chunk)
    assert (pl.chunk, pl.n_chunks, pl.tile) == (min(chunk, s), nc, tile)
    assert pl.states_shape == (b, h, nc, p, n)
    assert pl.decay_shape == (b, h, nc)
    assert pl.scratch_bytes == 4 * (b * h * nc * p * n + b * h * nc)
    hb = pl.heads_per_block
    assert 1 <= hb <= h and pl.grid == (nc, b, -(-h // hb))


def test_ssd_plan_of_the_serving_shape():
    """B·H·C·P·N fp32 chunk states: 134 MB at zamba2's prefill, and 1024
    blocks (chunk, batch, group of 8 heads), against 256 (batch, head)
    blocks of the sequential design."""
    pl = ssd_plan(4, 64, 4096, 64, 64, 128)
    assert pl.scratch_bytes == 134_217_728 + 4 * 4 * 64 * 32
    assert int(np.prod(pl.grid)) == 1024
    assert int(np.prod(ssd_plan(1, 64, 4096, 64, 64, 128).grid)) == 256


@pytest.mark.parametrize("s,p,n,chunk,match", [
    (100, 64, 64, 64, "multiple"),
    (128, 128, 64, 64, "widths"),
    (128, 64, 96, 64, "widths"),
])
def test_ssd_plan_refuses(s, p, n, chunk, match):
    with pytest.raises(ValueError, match=match):
        ssd_plan(1, 2, s, p, n, chunk)


# ------------------------------------------------------------ Mamba2 block
def _zamba_cfg():
    return tconfigs.get_smoke_config("zamba2-1.2b").replace(
        compute_dtype="float32", max_seq=S)


def _params(cfg, seed=0):
    jparams = jax_get_model(cfg).init(jax.random.PRNGKey(seed))
    return jparams, from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def test_mamba2_block_matches_jax_in_both_branches():
    cfg = _zamba_cfg()
    jparams, tparams = _params(cfg)
    jl = jax.tree.map(lambda a: a[1], jparams["layers"])
    tl = {k: v[1] for k, v in tparams["layers"].items()}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 32, cfg.d_model)).astype(np.float32)
    jblock = jax.jit(lambda p, x, st: JM.mamba2_block(p, x, cfg, state=st))
    out, st = TM.mamba2_block(tl, torch.from_numpy(x), cfg)
    ref, _ = jblock(jl, jnp.asarray(x), None)
    assert st is None
    _close(out, ref, 1e-4)

    _, nheads, conv_dim = TM._dims(cfg)
    s = cfg.ssm
    conv = rng.standard_normal((B, s.conv_width - 1, conv_dim)) \
        .astype(np.float32)
    ssm = rng.standard_normal((B, nheads, s.head_dim, s.state_dim)) \
        .astype(np.float32)
    out, (conv2, ssm2) = TM.mamba2_block(
        tl, torch.from_numpy(x[:, :1]), cfg, state=_t(conv, ssm))
    ref, (rconv, rssm) = jblock(jl, jnp.asarray(x[:, :1]), _j(conv, ssm))
    _close(out, ref, 1e-4)
    _close(conv2, rconv, 1e-6)
    _close(ssm2, rssm, 1e-4)


# ------------------------------------------------------ ring-cache decode
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("window", [None, 5])
def test_ring_cache_write_and_attention_match_jax(window, dtype, tol):
    """Write 11 tokens into a 7-slot ring (it wraps) and attend after each
    write, with and without a sliding window.  A bf16 cache, as the serving
    path holds it, is read in bf16 by both products, against JAX's bf16-in,
    fp32-accumulate einsums at the bf16 tolerance."""
    rng = np.random.default_rng(8)
    b, w, h, hkv, d = 2, 7, 6, 2, 16
    kc, vc = np.zeros((2, b, w, hkv, d), np.float32)
    kp = np.full((b, w), -1, np.int32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jc = [jnp.asarray(kc, jdt), jnp.asarray(vc, jdt), jnp.asarray(kp)]
    tc = [torch.from_numpy(kc).to(tdt), torch.from_numpy(vc).to(tdt),
          torch.from_numpy(kp.copy())]
    for t in range(11):
        pos = np.array([t, t + 3], np.int32)
        k, v = rng.standard_normal((2, b, 1, hkv, d)).astype(np.float32)
        q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
        jc = JL.cache_write(*jc, *_j(k, v, pos))
        ptrs = [x.data_ptr() for x in tc]
        tc = TL.cache_write(*tc, *_t(k, v, pos))
        assert [x.data_ptr() for x in tc] == ptrs          # in place
        for ours, ref in zip(tc, jc):
            np.testing.assert_array_equal(ours.float().numpy(),
                                          np.asarray(ref, np.float32))
        out = TL.decode_attention(torch.from_numpy(q).to(tdt), *tc,
                                  torch.from_numpy(pos),
                                  sliding_window=window)
        ref = JL.decode_attention(jnp.asarray(q, jdt), *jc,
                                  jnp.asarray(pos), sliding_window=window)
        assert out.dtype == tdt
        _close(out, np.asarray(ref, np.float32), tol)
    assert (tc[2] >= 0).all()                              # every slot used


# ------------------------------------------------------------- zamba2 smoke
@pytest.fixture(scope="module")
def zamba():
    cfg = _zamba_cfg()
    jparams, tparams = _params(cfg, seed=3)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (B, S))
    return cfg, jparams, tparams, tokens


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_interpret"])
def test_zamba2_forward_matches_jax(zamba, impl):
    cfg, jparams, tparams, tokens = zamba
    ref = jax_get_model(cfg).forward(jparams,
                                     {"tokens": jnp.asarray(tokens)})
    ours = get_model(cfg.replace(attn_impl=impl)).forward(
        tparams, {"tokens": torch.from_numpy(tokens)})
    assert ours.shape == ref.shape
    _close(ours, ref)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_zamba2_decode_matches_jax_logits_and_caches(zamba):
    cfg, jparams, tparams, tokens = zamba
    jm, tm = jax_get_model(cfg), get_model(cfg)
    jcache = jm.init_cache(B, S)
    tcache = from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    assert tcache["attn"]["key_pos"].dtype == torch.int32
    step = jax.jit(jm.decode_step)
    for t in range(S):
        batch = {"tokens": tokens[:, t:t + 1],
                 "pos": np.full((B,), t, np.int32)}
        jl, jcache = step(jparams, jcache, _j_dict(batch))
        tl, tcache = tm.decode_step(tparams, tcache, _t_dict(batch))
        _close(tl, jl)
    ref = _flat(jax.tree.map(np.asarray, jcache))
    ours = _flat(tcache)
    assert sorted(ours) == sorted(ref)
    for name, leaf in ours.items():
        assert leaf.dtype == getattr(torch, str(ref[name].dtype)), name
        _close(leaf, ref[name])


def _j_dict(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t_dict(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _greedy(prefill, serve, params, cache, prompt, new, lib):
    """Prefill a prompt for its first token, then teacher-force the prompt
    through the decode step and take ``new`` greedy tokens."""
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


def test_zamba2_greedy_tokens_match_jax(zamba):
    cfg, jparams, tparams, tokens = zamba
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
    # the prefill's token is the decode path's first greedy token
    assert ours[0] == list(ours[1][:, 0])


# ------------------------------------------- decode against forward, port
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "smollm-360m", "qwen2-7b"])
def test_decode_matches_forward(arch):
    """The JAX package's decode-vs-forward property, in the port alone."""
    cfg = tconfigs.get_smoke_config(arch).replace(compute_dtype="float32",
                                                  max_seq=S)
    model = get_model(cfg)
    params = model.init(3, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (B, S)))
    full = model.forward(params, {"tokens": tokens})
    cache = model.init_cache(B, S, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = model.decode_step(
            params, cache, {"tokens": tokens[:, t:t + 1],
                            "pos": torch.full((B,), t, dtype=torch.int32)})
        outs.append(logits[:, 0])
    _close(torch.stack(outs, dim=1), full)


def test_sliding_window_ring_cache():
    """Dense decode with a window smaller than the sequence: the ring
    overwrites old slots and masks by position."""
    cfg = tconfigs.get_smoke_config("smollm-360m").replace(
        compute_dtype="float32", sliding_window=6)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (B, S)))
    full = model.forward(params, {"tokens": tokens})
    cache = model.init_cache(B, S, device="cpu")         # width = window
    assert cache["k"].shape[2] == 6
    outs = []
    for t in range(S):
        logits, cache = model.decode_step(
            params, cache, {"tokens": tokens[:, t:t + 1],
                            "pos": torch.full((B,), t, dtype=torch.int32)})
        outs.append(logits[:, 0])
    _close(torch.stack(outs, dim=1), full)


def test_dense_decode_matches_jax():
    cfg = tconfigs.get_smoke_config("qwen2-7b").replace(
        compute_dtype="float32", max_seq=S)
    jparams, tparams = _params(cfg, seed=5)
    jm, tm = jax_get_model(cfg), get_model(cfg)
    jcache = jm.init_cache(B, S)
    tcache = from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (B, S))
    step = jax.jit(jm.decode_step)
    for t in range(S):
        batch = {"tokens": tokens[:, t:t + 1],
                 "pos": np.full((B,), t, np.int32)}
        jl, jcache = step(jparams, jcache, _j_dict(batch))
        tl, tcache = tm.decode_step(tparams, tcache, _t_dict(batch))
        _close(tl, jl)
    for name, leaf in _flat(jax.tree.map(np.asarray, jcache)).items():
        _close(_flat(tcache)[name], leaf)


# ------------------------------------------------------------------ device
def test_init_cache_on_the_asked_device():
    model = get_model(tconfigs.get_smoke_config("zamba2-1.2b"))
    cache = model.init_cache(2, 8, device="cpu")
    spec = _flat(model.cache_schema(2, 8))
    for name, leaf in _flat(cache).items():
        assert leaf.device.type == "cpu" and tuple(leaf.shape) \
            == spec[name].shape, name
    assert (cache["attn"]["key_pos"] == -1).all()
    assert cache["attn"]["key_pos"].dtype == torch.int32
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == torch.bfloat16         # compute dtype
    assert not cache["ssm"].any() and not cache["attn"]["k"].any()
    if torch.cuda.is_available():
        assert model.init_cache(1, 4)["ssm"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.init_cache(1, 4)
