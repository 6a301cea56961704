"""The port's kernel ops on the CPU (their plain versions) against the JAX
package's Pallas kernels in interpret mode and its oracles, on the same
inputs made with numpy from a seed.  The CUDA kernels themselves run only
on the card: ``chip_smoke.py`` holds them against these plain versions."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref, flash_attention
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import attention_plain
from repro_torch.kernels.flash_attention import attention_plain_bwd
from repro_torch.kernels.flash_attention import flash_attention as t_flash
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.kernel import plan as flash_plan
from repro_torch.kernels.flash_attention.kernel import plan_bwd
from repro_torch.kernels.flash_attention.kernel import tma_view_problem
from repro_torch.kernels.paged_attention import paged_attention as t_paged
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.kernels.paged_attention.kernel import paged_attention_fwd

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (bf16 rounds
    identically in both)."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(rng, b, sq, h, hkv, d, dtype):
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [_pair(mk(b, sq, n, d), dtype) for n in (h, hkv, hkv)]


# ------------------------------------------------------- flash attention
@pytest.mark.parametrize("b,sq,h,hkv,d", [
    (2, 256, 4, 2, 64),
    (1, 128, 8, 8, 128),
    (2, 512, 4, 1, 64),      # MQA
    (1, 384, 6, 2, 128),     # non-power-of-two seq (3 blocks)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax(b, sq, h, hkv, d, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(np.random.default_rng(7), b, sq, h,
                                        hkv, d, dtype)
    out = t_flash(qt, kt, vt, causal=True)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    tol = TOL[dtype]
    for ref in (flash_attention(qj, kj, vj, True, None, 128, 128, True),
                attention_ref(qj, kj, vj, causal=True)):
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [64, 200])
def test_flash_plain_sliding_window(window):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(np.random.default_rng(8), 2, 256, 4,
                                        2, 64, "float32")
    out = t_flash(qt, kt, vt, causal=True, sliding_window=window)
    ref = attention_ref(qj, kj, vj, causal=True, sliding_window=window)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-5, rtol=2e-5)


def test_flash_plain_edge_masks():
    """A window of 1 attends to the token itself; a row that sees no key
    (non-causal, window past the end of k) gives 0, not NaN."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 4, 32))
                                .astype(np.float32)) for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]                       # G = 2
    own = attention_plain(q, k, v, causal=True, sliding_window=1)
    np.testing.assert_allclose(own.numpy(),
                               v.repeat_interleave(2, dim=2).numpy(),
                               atol=1e-6)
    out = attention_plain(q, k[:, :4], v[:, :4], causal=False,
                          sliding_window=2)
    assert torch.isfinite(out).all()
    assert out[:, 5:].abs().max() == 0 and out[:, :5].abs().max() > 0


def test_flash_grad_matches_jax():
    (qj, qt), (kj, kt), (vj, vt) = _qkv(np.random.default_rng(10), 1, 128, 2,
                                        2, 64, "float32")
    inputs = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    t_flash(*inputs, causal=True).sum().backward()
    gk = jax.grad(lambda q, k, v: jnp.sum(
        flash_attention(q, k, v, True, None, 64, 64, True)),
        argnums=(0, 1, 2))(qj, kj, vj)
    gr = jax.grad(lambda q, k, v: jnp.sum(
        attention_ref(q, k, v, causal=True)), argnums=(0, 1, 2))(qj, kj, vj)
    for t, a, r in zip(inputs, gk, gr):
        np.testing.assert_allclose(_f32(t.grad), _f32(a), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(_f32(t.grad), _f32(r), atol=1e-4,
                                   rtol=1e-4)


# ------------------------------------------- flash attention, backward
def _plain_grads(q, k, v, g, **mask):
    """dq, dk, dv by autograd through the plain forward."""
    inputs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = attention_plain(*inputs, **mask)
    return torch.autograd.grad(out, inputs, g)


def _kernel_algorithm(q, k, v, g, **mask):
    """The backward kernel's algorithm: the forward's log-sum-exp, then
    `attention_plain_bwd`."""
    out, lse = attention_plain(q, k, v, return_lse=True, **mask)
    return attention_plain_bwd(q, k, v, out, lse, g, **mask)


def _close(got, want, tol):
    for a, r in zip(got, want):
        np.testing.assert_allclose(_f32(a), _f32(r), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,sq,h,hkv,d", [
    (2, 256, 4, 2, 64),
    (1, 128, 8, 8, 128),
    (2, 512, 4, 1, 64),      # MQA
    (1, 384, 6, 2, 128),     # non-power-of-two seq (3 blocks)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_bwd_matches_autograd_and_jax(b, sq, h, hkv, d, dtype):
    """The backward kernel's algorithm against autograd through the plain
    forward (the op's recompute) and against jax.grad of the JAX package's
    op.  bf16: the JAX op rounds P to bf16 before P·V and its backward runs
    its einsums in bf16, so it is held at bf16's tolerance on the scale of
    the gradients."""
    rng = np.random.default_rng(11)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, b, sq, h, hkv, d, dtype)
    gj, gt = _pair(rng.standard_normal((b, sq, h, d)).astype(np.float32),
                   dtype)
    got = _kernel_algorithm(qt, kt, vt, gt, causal=True)
    assert [t.dtype for t in got] == [qt.dtype] * 3
    tol = TOL[dtype] if dtype == "bfloat16" else 1e-4
    _close(got, _plain_grads(qt, kt, vt, gt, causal=True), tol)
    _, vjp = jax.vjp(lambda q, k, v: flash_attention(
        q, k, v, True, None, 128, 128, True), qj, kj, vj)
    want = vjp(gj)
    scale = max(float(np.abs(_f32(w)).max()) for w in want)
    _close(got, want, tol if dtype == "float32" else 2 * tol * scale)


@pytest.mark.parametrize("sq,skv,causal,window", [
    (96, 160, True, None),    # fewer queries than keys, top-left diagonal
    (160, 96, True, None),
    (96, 160, False, None),
    (160, 96, False, 80),
    (256, 256, True, 64),
    (256, 256, True, 200),
    (256, 256, False, 64),
])
def test_flash_plain_bwd_masks(sq, skv, causal, window):
    rng = np.random.default_rng(12)
    (qj, qt), _, _ = _qkv(rng, 2, sq, 4, 2, 32, "float32")
    (kj, kt), (vj, vt) = (_pair(rng.standard_normal((2, skv, 2, 32))
                                .astype(np.float32), "float32")
                          for _ in range(2))
    gj, gt = _pair(rng.standard_normal((2, sq, 4, 32)).astype(np.float32),
                   "float32")
    mask = dict(causal=causal, sliding_window=window)
    got = _kernel_algorithm(qt, kt, vt, gt, **mask)
    _close(got, _plain_grads(qt, kt, vt, gt, **mask), 1e-4)
    _, vjp = jax.vjp(lambda q, k, v: flash_attention(
        q, k, v, causal, window, 32, 32, True), qj, kj, vj)
    _close(got, vjp(gj), 1e-4)


def test_flash_plain_bwd_edge_masks():
    """A row that sees no key (non-causal, window past the end of k) has
    lse +inf, weight 0 and gradients 0, never NaN; the keys it would have
    seen get nothing from it.  A window of 1 sends each row's gradient to
    its own key alone."""
    rng = np.random.default_rng(13)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 8, 4, 32))
                                   .astype(np.float32)) for _ in range(4))
    k, v = k[:, :4, :2], v[:, :4, :2]                    # G = 2, Skv = 4
    mask = dict(causal=False, sliding_window=2)          # rows 5.. see none
    out, lse = attention_plain(q, k, v, return_lse=True, **mask)
    assert torch.isinf(lse[:, :, 5:]).all() and lse[:, :, 5:].min() > 0
    assert torch.isfinite(lse[:, :, :5]).all()
    got = attention_plain_bwd(q, k, v, out, lse, g, **mask)
    assert all(torch.isfinite(t).all() for t in got)
    assert got[0][:, 5:].abs().max() == 0 and got[0][:, :5].abs().max() > 0
    _close(got, _plain_grads(q, k, v, g, **mask), 1e-5)
    # rows 5.. changed nothing: the same gradients without them
    part = attention_plain_bwd(q[:, :5], k, v, out[:, :5], lse[:, :, :5],
                               g[:, :5], **mask)
    _close(got[1:], part[1:], 1e-6)
    k1, v1 = (torch.from_numpy(rng.standard_normal((1, 8, 1, 32))
                               .astype(np.float32)) for _ in range(2))
    own = _kernel_algorithm(q, k1, v1, g, causal=True, sliding_window=1)
    for t in own[:2]:                      # P is 1, so dS is 0
        np.testing.assert_allclose(t.numpy(), 0, atol=1e-5)
    np.testing.assert_allclose(own[2].numpy(),
                               g.sum(2, keepdim=True).numpy(), atol=1e-5)


def test_flash_plain_lse_is_the_rows_logsumexp():
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 50, n, 64))
                                .astype(np.float32)) for n in (6, 2, 2))
    _, lse = attention_plain(q, k, v, causal=True, sliding_window=20,
                             return_lse=True)
    logits = torch.einsum("bqhd,bkhd->bhqk", q,
                          k.repeat_interleave(3, dim=2)) / 8.0
    pos = torch.arange(50)
    seen = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - 20)
    want = torch.logsumexp(logits.masked_fill(~seen, -float("inf")), -1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-6)


class _FakeCard:
    """The op's kernels replaced by their plain versions, counting what the
    op asked for."""

    def __init__(self, monkeypatch):
        self.fwd_lse, self.bwd_calls = [], 0
        monkeypatch.setattr(flash_ops, "_on_card", lambda t: True)
        monkeypatch.setattr(flash_kernel, "flash_attention_fwd", self.fwd)
        monkeypatch.setattr(flash_kernel, "flash_attention_bwd", self.bwd)

    def fwd(self, q, k, v, *, causal, sliding_window, return_lse=False):
        self.fwd_lse.append(return_lse)
        return attention_plain(q, k, v, causal=causal,
                               sliding_window=sliding_window,
                               return_lse=return_lse)

    def bwd(self, q, k, v, out, lse, dout, *, causal, sliding_window):
        self.bwd_calls += 1
        return attention_plain_bwd(q, k, v, out, lse, dout, causal=causal,
                                   sliding_window=sliding_window)


@pytest.mark.parametrize("dtype,needs,want", [
    (torch.bfloat16, (True, True, True), True),
    (torch.bfloat16, (False, True, False), True),     # k alone (a frozen q)
    (torch.bfloat16, (False, False, False), False),   # prefill, no_grad
    (torch.float32, (True, True, True), False),       # fp32: plain recompute
])
def test_flash_forward_saves_lse_only_for_a_gradient(monkeypatch, dtype,
                                                     needs, want):
    card = _FakeCard(monkeypatch)
    rng = np.random.default_rng(15)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 64, n, 32))
                                   .astype(np.float32)).to(dtype)
                  for n in (4, 2, 2, 4))
    inputs = [t.clone().requires_grad_(r) for t, r in zip((q, k, v), needs)]
    out = t_flash(*inputs, causal=True, sliding_window=48)
    assert card.fwd_lse == [want]
    if not any(needs):
        with torch.no_grad():
            t_flash(q, k, v, causal=True)
        assert card.fwd_lse == [False, False]
        return
    out.backward(g)
    assert card.bwd_calls == int(want)
    ref = _plain_grads(q, k, v, g, causal=True, sliding_window=48)
    for t, r, need in zip(inputs, ref, needs):
        if need:
            np.testing.assert_allclose(_f32(t.grad), _f32(r), atol=2e-2,
                                       rtol=2e-2)


# -------------------------------------------------------- paged attention
def _paged_inputs(rng, b, h, hkv, d, pages, t, pp, dtype):
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    # the engine's layout: a [L, P, T, Hkv, D] pool; the kernel is handed
    # layer 1 as a strided [P, T, Hkv, D] view
    pool = rng.standard_normal((2, 2, pages, t, hkv, d)).astype(np.float32)
    lengths = rng.integers(1, pp * t + 1, size=b).astype(np.int32)
    lengths[0] = t * max(1, pp // 2)        # an exact page multiple
    tbl = np.full((b, pp), -1, np.int32)
    free = list(rng.permutation(np.arange(1, pages)))  # page 0: -1 slots
    for i, ln in enumerate(lengths):
        for j in range(-(-int(ln) // t)):
            tbl[i, j] = free.pop()
    qj, qt = _pair(q, dtype)
    pj, pt = _pair(pool, dtype)
    return qj, qt, pj, pt, tbl, lengths


@pytest.mark.parametrize("b,h,hkv,d,pages,t,pp", [
    (3, 8, 2, 64, 32, 16, 8),
    (2, 4, 4, 128, 16, 32, 4),
    (1, 16, 1, 64, 64, 16, 16),   # MQA, long table
    (4, 28, 4, 128, 48, 16, 10),  # qwen2-7b heads: G = 7
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_jax(b, h, hkv, d, pages, t, pp, dtype):
    qj, qt, pj, pt, tbl, lengths = _paged_inputs(
        np.random.default_rng(11), b, h, hkv, d, pages, t, pp, dtype)
    kt, vt = pt[0, 1], pt[1, 1]
    assert not kt.is_contiguous() or kt.storage_offset() > 0
    out = t_paged(qt, kt, vt, torch.from_numpy(tbl),
                  torch.from_numpy(lengths))
    assert out.dtype == qt.dtype and out.shape == qt.shape
    ref = jax_paged(qj, pj[0, 1], pj[1, 1], jnp.asarray(tbl),
                    jnp.asarray(lengths), interpret=True)
    oracle = paged_attention_ref(qj, jnp.moveaxis(pj[0, 1], 2, 0),
                                 jnp.moveaxis(pj[1, 1], 2, 0),
                                 jnp.asarray(tbl), jnp.asarray(lengths))
    tol = TOL[dtype]
    for r in (ref, oracle):
        np.testing.assert_allclose(_f32(out), _f32(r), atol=tol, rtol=tol)


def test_paged_plain_reads_only_the_length():
    """Garbage past a sequence's length, and in page 0 (what -1 table
    entries name), must not reach the output."""
    qj, qt, pj, pt, tbl, lengths = _paged_inputs(
        np.random.default_rng(12), 3, 8, 2, 64, 32, 16, 8, "float32")
    k, v = pt[0, 1].clone(), pt[1, 1].clone()
    tbl_t, len_t = torch.from_numpy(tbl), torch.from_numpy(lengths)
    base = paged_attention_plain(qt, k, v, tbl_t, len_t)
    for i, ln in enumerate(lengths):
        page, slot = divmod(int(ln), 16)
        if page < 8 and tbl[i, page] >= 0:
            k[tbl[i, page], slot:] = 1e4
            v[tbl[i, page], slot:] = 1e4
    k[0], v[0] = 1e4, 1e4
    assert (tbl == -1).any() and 0 not in tbl
    out = paged_attention_plain(qt, k, v, tbl_t, len_t)
    np.testing.assert_allclose(out.numpy(), base.numpy(), atol=1e-6)


# ------------------------------------------------- the kernels' wrappers
def test_kernel_wrappers_refuse_cpu_tensors():
    """A launch wrapper takes CUDA tensors only: it never falls back."""
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, q, q)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, q, q, q, lse, q)
    # the fp32 kernel keeps no log-sum-exp: its backward is the plain one
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_fwd(q, q, q, return_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_fwd(torch.zeros(1, 2, 32), torch.zeros(4, 4, 1, 32),
                            torch.zeros(4, 4, 1, 32),
                            torch.zeros(1, 2, dtype=torch.int32),
                            torch.ones(1, dtype=torch.int32))


def test_kernel_sources_build_inside_the_repo():
    repo = _build.CSRC.parents[2]
    assert (repo / "conftest.py").exists()
    assert _build.BUILD_DIR == repo / "build" / "repro_torch"
    headers = sorted(_build.CSRC.glob("*.cuh"))
    assert [h.name for h in headers] == ["hopper.cuh"]
    for name, entry in (("flash_attention", "flash_attention_fwd"),
                        ("flash_attention_bwd", "flash_attention_bwd"),
                        ("paged_attention", "paged_attention_fwd"),
                        ("mamba2_scan", "ssd_scan_fwd")):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f'int {entry}(' in src and "repro_error_string" in src
        assert _build.sources(name) == [_build.CSRC / f"{name}.cu",
                                        *headers]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # the header is TMA and wgmma for the flash kernel; nothing links
    # libcuda: the tensor map's encoder comes from the runtime
    hdr = headers[0].read_text()
    assert "cudaGetDriverEntryPoint" in hdr and "wgmma.mma_async" in hdr
    assert '#include "hopper.cuh"' in (
        _build.CSRC / "flash_attention.cu").read_text()
    assert not any("cuda" in f for f in _build.NVCC_FLAGS if f[:2] == "-l")


def test_a_library_is_stale_when_its_source_or_a_header_is_newer(
        tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    cu, hdr, lib = csrc / "k.cu", csrc / "shared.cuh", build / "k.so"
    for f, when in ((cu, 100), (hdr, 100), (lib, 200)):
        f.write_text("")
        os.utime(f, (when, when))
    assert not _build._stale("k")
    os.utime(hdr, (300, 300))
    assert _build._stale("k")            # a shared header changed
    os.utime(lib, (400, 400))
    os.utime(cu, (500, 500))
    assert _build._stale("k")            # its own source changed
    lib.unlink()
    assert _build._stale("k")            # never built


@pytest.mark.parametrize("dtype,b,sq,h,d,want", [
    (torch.bfloat16, 1, 564, 28, 128, (128, 64, (5, 28, 1))),   # qwen2
    (torch.bfloat16, 4, 4096, 32, 64, (128, 64, (32, 32, 4))),   # zamba2
    (torch.bfloat16, 2, 300, 4, 32, (128, 64, (3, 4, 2))),
    (torch.float32, 1, 564, 28, 128, (64, 32, (9, 28, 1))),
])
def test_flash_plan_tiles_and_grid(dtype, b, sq, h, d, want):
    assert tuple(flash_plan(dtype, b, sq, h, d)) == want
    # the library is built for these tiles and refuses others
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert "BQ = 128" in src and "BK = 64" in src
    assert "F_BQ = 64" in src and "F_BK = 32" in src


@pytest.mark.parametrize("b,sq,skv,hkv,want", [
    (4, 2048, 2048, 5, (64, 128, 2048, (16, 5, 4))),   # smollm train
    (1, 564, 564, 4, (64, 128, 576, (5, 4, 1))),       # qwen2's prompt
    (2, 300, 77, 2, (64, 128, 320, (1, 2, 2))),        # Sq > Skv
    (1, 30, 1500, 16, (64, 128, 64, (12, 16, 1))),
])
def test_flash_plan_bwd_tiles_and_grid(b, sq, skv, hkv, want):
    assert tuple(plan_bwd(b, sq, skv, hkv)) == want
    # the library is built for these tiles and refuses others; its kernels'
    # names hold `flash_bwd` and never the forward's `flash_bf16`, which
    # the benchmark's readers tell apart by name
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    assert "BKV = 128" in src and "BQ = 64" in src
    kernels = [line.split("(")[0] for line in src.splitlines()
               if line.startswith("flash_bwd")]
    assert kernels == ["flash_bwd_prep", "flash_bwd", "flash_bwd_dq"]
    assert "flash_bf16" not in src.replace("`flash_bf16`", "")


def _tma_problem(t: torch.Tensor):
    return tma_view_problem(t.shape, t.stride(), t.element_size(),
                            t.data_ptr())


@pytest.mark.parametrize("arch", ["qwen2-7b", "zamba2-1.2b"])
def test_tma_accepts_the_models_views(arch):
    """q, k, v as the model makes them (rotated, contiguous) and as slices
    of one fused projection, at the arch's head counts."""
    cfg = get_config(arch)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    fused = torch.zeros((2, 37, h + 2 * hkv, d), dtype=torch.bfloat16)
    views = [fused[:, :, :h], fused[:, :, h:h + hkv],
             fused[:, :, h + hkv:],
             torch.zeros((1, 37, h, d), dtype=torch.bfloat16),
             torch.zeros((2, 37, hkv, d), dtype=torch.bfloat16)]
    assert [_tma_problem(v) for v in views] == [None] * 5


def test_tma_refuses_views_it_cannot_read():
    x = torch.zeros((2, 16, 8, 64), dtype=torch.bfloat16)
    flat = torch.zeros(2 * 16 * 8 * 64 + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + x.numel()].view(x.shape)          # 2-byte offset
    assert "aligned" in _tma_problem(shifted)
    assert "last stride" in _tma_problem(x[..., ::2])
    assert "last stride" in _tma_problem(x.transpose(2, 3))
    odd = torch.zeros((2, 16, 8, 60), dtype=torch.bfloat16)[:, :, :, :56]
    assert "multiple of 16" in _tma_problem(odd)            # 120-byte rows
    # a size-1 dimension's stride is never stepped, so it does not count
    assert _tma_problem(x[:1, :, :1].expand(1, 16, 1, 64)) is None
    assert _tma_problem(torch.zeros((1, 4, 1, 32), dtype=torch.bfloat16)
                        .as_strided((1, 4, 1, 32), (7, 32, 3, 1))) is None
