"""The split-KV design of the port's paged decode-attention kernel, on the
CPU: its launch plan (``plan``), and the split-and-merge rule it computes,
stated here in plain torch and held against the port's plain version and
the JAX package's Pallas kernel in interpret mode on the same inputs.  The
CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against ``paged_attention_plain`` there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as jax_paged
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.kernels.paged_attention import kernel as pk
from repro_torch.kernels.paged_attention.ref import NEG_INF
from test_torch_kernels import TOL, _f32, _paged_inputs

SMEM_LIMIT = 232_448          # bytes of shared memory an H100 block may have


def split_merge_plain(q, k_pages, v_pages, page_table, lengths,
                      split_pages):
    """The kernel's rule in plain torch: each span of ``split_pages`` table
    columns gives fp32 partials (acc, m, l) over its valid positions; the
    spans are merged by log-sum-exp, spans with l = 0 left out."""
    b, h, d = q.shape
    _, t, hkv, _ = k_pages.shape
    pp = page_table.shape[1]
    qg = q.reshape(b, hkv, h // hkv, d).float() / np.sqrt(d)
    accs, ms, ls = [], [], []
    for p0 in range(0, pp, split_pages):
        cols = page_table[:, p0:p0 + split_pages].long().clamp_min(0)
        n = cols.shape[1] * t
        k = k_pages[cols].reshape(b, n, hkv, d).float()
        v = v_pages[cols].reshape(b, n, hkv, d).float()
        s = torch.einsum("bhgd,bshd->bhgs", qg, k)
        pos = p0 * t + torch.arange(n)
        valid = (pos[None, :] < lengths[:, None].long())[:, None, None, :]
        s = s.masked_fill(~valid, NEG_INF)
        m = s.amax(dim=-1)
        e = torch.exp(s - m[..., None]) * valid
        accs.append(torch.einsum("bhgs,bshd->bhgd", e, v))
        ms.append(m)
        ls.append(e.sum(dim=-1))
    acc, m, l = torch.stack(accs), torch.stack(ms), torch.stack(ls)
    m = torch.where(l > 0, m, NEG_INF)
    w = torch.exp(m - m.amax(dim=0)) * (l > 0)
    out = (w[..., None] * acc).sum(dim=0) \
        / (w * l).sum(dim=0).clamp_min(1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def _check_against_references(qj, qt, pj, pt, tbl, lengths, dtype):
    """split_merge_plain at the plan's spans against the port's plain
    version and JAX's Pallas kernel (interpret mode)."""
    kt, vt = pt[0, 1], pt[1, 1]
    b, h, d = qt.shape
    _, t, hkv, _ = kt.shape
    pl = pk.plan(b, h, hkv, d, t, tbl.shape[1], qt.dtype)
    tbl_t, len_t = torch.from_numpy(tbl), torch.from_numpy(lengths)
    out = split_merge_plain(qt, kt, vt, tbl_t, len_t, pl.split_tokens // t)
    assert out.dtype == qt.dtype and torch.isfinite(out).all()
    plain = paged_attention_plain(qt, kt, vt, tbl_t, len_t)
    ref = jax_paged(qj, pj[0, 1], pj[1, 1], jnp.asarray(tbl),
                    jnp.asarray(lengths), interpret=True)
    tol = TOL[dtype]
    for r in (plain, ref):
        np.testing.assert_allclose(_f32(out), _f32(r), atol=tol, rtol=tol)
    return pl, out


# --------------------------------------------------------------- the plan
@pytest.mark.parametrize("t", [1, 8, 16, 64, 128])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_covers_the_table_in_whole_pages(t, d, dtype):
    for g in (1, 7, 8, 12, 32):
        for pp in (1, 37, 256):
            for b, hkv in ((1, 1), (8, 4), (64, 8)):
                pl = pk.plan(b, g * hkv, hkv, d, t, pp, dtype)
                span = pl.split_tokens // t
                assert pl.split_tokens == span * t and span >= 1
                # every column in a span, no span wholly past the table
                assert pl.splits * pl.split_tokens >= pp * t
                assert (pl.splits - 1) * span < pp
                assert pl.split_tokens >= min(pk.SPLIT_TOKENS, pp * t)
                assert pl.grid == (hkv, b, pl.splits)
                assert pl.merge == (pl.splits > 1)
                if span > -(-pk.SPLIT_TOKENS // t):
                    # spans grew past the least only where the grid keeps
                    # its two blocks per SM
                    assert hkv * b * pl.splits >= pk.FILL_BLOCKS
                assert pl.threads == pk.THREADS
                assert pl.smem_bytes <= SMEM_LIMIT
                assert pl.acc_shape == (b, g * hkv, pl.splits, d)
                assert pl.ml_shape == (b, g * hkv, pl.splits, 2)


def test_plan_fills_the_card_at_the_serving_shape():
    """qwen2-7b decode at batch 8, ~580 tokens in 16-token pages: a block
    per (kv head, sequence, 64-token span), at least two per SM."""
    pl = pk.plan(8, 28, 4, 128, 16, 37, torch.bfloat16)
    assert (pl.split_tokens, pl.splits, pl.grid) == (64, 10, (4, 8, 10))
    assert np.prod(pl.grid) >= 2 * 132 and pl.merge
    # the K/V ring (3 stages of 32 tokens, bf16) and fp32 q, scores, m, l, a
    assert pl.smem_bytes == 3 * 2 * 32 * 128 * 2 + 4 * (7 * 128 + 7 * 33
                                                         + 3 * 7)
    # a one-page table is one span: the first kernel writes the output
    one = pk.plan(8, 28, 4, 128, 16, 1, torch.bfloat16)
    assert one.splits == 1 and not one.merge


@pytest.mark.parametrize("args,match", [
    ((8, 28, 4, 96, 16, 37, torch.bfloat16), "head dim 96"),
    ((8, 33, 1, 128, 16, 37, torch.bfloat16), "33 heads over 1"),
    ((8, 28, 3, 128, 16, 37, torch.bfloat16), "28 heads over 3"),
    ((8, 28, 4, 128, 16, 37, torch.float16), "dtype"),
    ((8, 28, 4, 128, 0, 37, torch.bfloat16), "0 tokens per page"),
])
def test_plan_refuses_what_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        pk.plan(*args)


def test_plan_matches_the_built_kernel():
    src = (_build.CSRC / "paged_attention.cu").read_text()
    assert f"THREADS = {pk.THREADS};" in src
    assert f"NT = {pk.TILE_TOKENS};" in src
    assert f"STAGES = {pk.STAGES};" in src
    # no page-size limit is left in the wrapper
    assert not hasattr(pk, "MAX_PAGE_TOKENS")
    assert "paged_merge" in src and '#include "hopper.cuh"' in src


def test_engine_pool_layers_pass_the_16_byte_load_check():
    """The engine's [L, P, T, Hkv, D] pools, one layer at a time, are read
    in place by 16-byte copies: a unit head-dim stride and a 16-byte
    aligned base and other strides, which the C entry checks before it
    launches; a view with a strided head dim is refused."""
    def loadable(x):
        return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
                and all(st * x.element_size() % 16 == 0
                        for st in x.stride()[:-1]))

    for dtype in (torch.float32, torch.bfloat16):
        pool = torch.zeros((3, 8, 16, 4, 128), dtype=dtype)
        assert all(loadable(pool[li]) for li in range(3))
        assert not loadable(pool[0].transpose(2, 3))
    src = (_build.CSRC / "paged_attention.cu").read_text()
    assert "return static_cast<int>(cudaErrorMisalignedAddress);" in src


# ----------------------------------------------- the split-and-merge rule
@pytest.mark.parametrize("b,h,hkv,d,pages,t,pp", [
    (3, 8, 2, 64, 32, 16, 8),
    (2, 4, 4, 128, 16, 32, 4),
    (1, 16, 1, 64, 64, 16, 16),   # MQA, long table
    (4, 28, 4, 128, 48, 16, 10),  # qwen2-7b heads: G = 7
    (2, 96, 8, 128, 24, 16, 6),   # mistral-large heads: G = 12
    (2, 8, 2, 32, 256, 1, 100),   # one-token pages: spans of 64 pages
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_merge_matches_plain_and_jax(b, h, hkv, d, pages, t, pp,
                                           dtype):
    args = _paged_inputs(np.random.default_rng(21), b, h, hkv, d, pages, t,
                         pp, dtype)
    _check_against_references(*args, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_merge_with_empty_spans_and_a_zero_length(dtype):
    """Short sequences in a wide table leave whole spans empty (m = -1e30,
    l = 0, left out of the merge); a length of 0 gives a row of zeros."""
    qj, qt, pj, pt, tbl, lengths = _paged_inputs(
        np.random.default_rng(22), 5, 8, 2, 64, 256, 16, 40, dtype)
    lengths = np.array([0, 1, 16, 64, 640], np.int32)
    pl, out = _check_against_references(qj, qt, pj, pt, tbl, lengths,
                                        dtype)
    assert pl.splits == 10 and pl.split_tokens == 64
    assert out[0].abs().max() == 0 and out[1:].abs().amax(-1).min() > 0
    # sequences 0-3 fit the first span: the rule reads nothing else
    k, v = pt[0, 1].clone(), pt[1, 1].clone()
    beyond = tbl[:4, 4:][tbl[:4, 4:] >= 0]
    assert beyond.size > 0
    k[beyond], v[beyond] = 1e4, 1e4
    again = split_merge_plain(qt, k, v, torch.from_numpy(tbl),
                              torch.from_numpy(lengths), 4)
    np.testing.assert_allclose(_f32(again[:4]), _f32(out[:4]), atol=0)


def test_split_merge_does_not_depend_on_the_span():
    """Any span of whole pages gives the same output as the one-span rule
    (within fp32 rounding)."""
    qj, qt, pj, pt, tbl, lengths = _paged_inputs(
        np.random.default_rng(23), 4, 28, 4, 128, 48, 16, 10, "float32")
    args = (qt, pt[0, 1], pt[1, 1], torch.from_numpy(tbl),
            torch.from_numpy(lengths))
    one = split_merge_plain(*args, 10)
    for span in (1, 2, 3, 4, 7):
        np.testing.assert_allclose(split_merge_plain(*args, span).numpy(),
                                   one.numpy(), atol=2e-6, rtol=2e-6)
