"""Launch wrapper of the hand-written CUDA paged decode attention
(``src/repro_torch/csrc/paged_attention.cu``).

Takes CUDA tensors only; it checks them, allocates the output (and the
split kernel's fp32 scratch) and launches on PyTorch's current stream.  The
pools may be any strided [P, T, Hkv, D] view (one layer of the engine's
[L, P, T, Hkv, D] pool) whose head dim is contiguous and whose base and
other strides are 16-byte aligned: they are read through their strides,
never copied.  The C entry point checks that before it launches, and
refuses a view that is not (a ``RuntimeError`` through `_build.check`).

`plan` sizes a call from the shapes alone (never from the lengths on the
device): the tokens of the table each block takes, the number of spans
(``splits``), the grid (Hkv, B, splits), the shared memory and the scratch
of per-span partials, and whether the merge kernel runs (more than one
span).  One wrapper call is one C call, which launches the split kernel
and, where it runs, the merge; ``launches`` counts the wrapper's calls
that launched, whether one kernel or two.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build

launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 32            # query heads per kv head the kernel is built for

# as paged_attention.cu is built: 128 threads walk 32-token tiles through a
# 3-stage ring of K and V tiles in shared memory
THREADS, TILE_TOKENS, STAGES = 128, 32, 3
SPLIT_TOKENS = 64         # least tokens of the table a block takes
FILL_BLOCKS = 2 * 132     # spans grow while the grid keeps this many


class Plan(NamedTuple):
    split_tokens: int     # tokens of the table each block takes
    splits: int           # spans of whole pages per sequence
    grid: tuple           # (Hkv, B, splits)
    threads: int
    smem_bytes: int
    acc_shape: tuple      # [B, H, splits, D] fp32 partial sums
    ml_shape: tuple       # [B, H, splits, 2] fp32 (max, denominator)
    merge: bool           # more than one span: the merge kernel runs


@functools.lru_cache(maxsize=256)
def plan(b: int, h: int, hkv: int, d: int, t: int, pp: int,
         dtype: torch.dtype) -> Plan:
    """The launch plan of one call for batch ``b``, ``h`` query and ``hkv``
    kv heads of dim ``d``, ``t``-token pages and a ``pp``-page table.
    Each block takes at least `SPLIT_TOKENS` tokens of whole pages, and
    more where the grid (Hkv · B · splits) keeps `FILL_BLOCKS` blocks, two
    per SM, with longer spans: fewer partials to merge.  Raises
    ``ValueError`` on what the kernel does not take.  Cached: a decode
    step asks again with the same shapes for every layer."""
    if dtype not in DTYPES:
        raise ValueError(f"paged_attention_fwd: dtype {dtype}; one of "
                         f"{list(DTYPES)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention_fwd: head dim {d}; one of "
                         f"{HEAD_DIMS}")
    if hkv < 1 or h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"paged_attention_fwd: {h} heads over {hkv} kv "
                         f"heads (at most {MAX_GROUP} per kv head)")
    if min(b, t, pp) < 1:
        raise ValueError(f"paged_attention_fwd: batch {b}, {t} tokens per "
                         f"page, {pp} table columns")
    g = h // hkv
    fill_splits = -(-FILL_BLOCKS // (b * hkv))
    span = max(-(-SPLIT_TOKENS // t), pp // fill_splits)      # pages
    splits = -(-pp // span)
    ring = STAGES * 2 * TILE_TOKENS * d * dtype.itemsize
    smem = ring + 4 * (g * d + g * (TILE_TOKENS + 1) + 3 * g)
    return Plan(span * t, splits, (hkv, b, splits), THREADS, smem,
                (b, h, splits, d), (b, h, splits, 2), splits > 1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.paged_attention_fwd.argtypes = (
        [P] * 8 + [I] * 11 + [LL] * 14 + [ctypes.c_float, P])
    lib.paged_attention_fwd.restype = I
    return lib


def paged_attention_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """q: [B, H, D]; k_pages/v_pages: [P, T, Hkv, D]; page_table: [B, PP]
    int32 (-1 = unused); lengths: [B] int32 → [B, H, D] in q's dtype."""
    global launches
    tensors = (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
               ("page_table", page_table), ("lengths", lengths))
    for name, x in tensors:
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"paged_attention_fwd: {name} is not a CUDA "
                             "tensor on q's device")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_attention_fwd: dtypes q {q.dtype} k "
                         f"{k_pages.dtype} v {v_pages.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention_fwd: page_table and lengths "
                         "must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention_fwd: shapes q {tuple(q.shape)} "
                         f"k {tuple(k_pages.shape)} v "
                         f"{tuple(v_pages.shape)}")
    b, h, d = q.shape
    _, t, hkv, _ = k_pages.shape
    pp = page_table.shape[-1]
    if k_pages.shape[3] != d:
        raise ValueError(f"paged_attention_fwd: head dim {d} vs pool "
                         f"{k_pages.shape[3]}")
    if tuple(page_table.shape) != (b, pp) or tuple(lengths.shape) != (b,):
        raise ValueError(f"paged_attention_fwd: table "
                         f"{tuple(page_table.shape)} lengths "
                         f"{tuple(lengths.shape)} for batch {b}")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or pp == 0:
        return out.zero_()
    pl = plan(b, h, hkv, d, t, pp, q.dtype)
    page_table = page_table.contiguous()
    lengths = lengths.contiguous()
    acc_ptr = ml_ptr = None
    if pl.merge:        # one fp32 allocation: the partial sums, then (m, l)
        n_acc = b * h * pl.splits * d                  # pl.acc_shape
        scratch = torch.empty(n_acc + 2 * b * h * pl.splits,   # + ml_shape
                              dtype=torch.float32, device=q.device)
        acc_ptr = scratch.data_ptr()
        ml_ptr = acc_ptr + 4 * n_acc
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.paged_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            acc_ptr, ml_ptr,
            DTYPES[q.dtype], b, h, hkv, d, t, pp, pl.split_tokens,
            pl.splits, pl.threads, pl.smem_bytes, *q.stride(),
            *k_pages.stride(), *v_pages.stride(), *out.stride(),
            1.0 / np.sqrt(d), stream)
    _build.check(lib, code, "paged_attention_fwd")
    launches += 1
    return out
