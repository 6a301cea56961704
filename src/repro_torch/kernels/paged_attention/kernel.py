"""Launch wrapper of the hand-written CUDA paged decode attention
(``src/repro_torch/csrc/paged_attention.cu``).

Takes CUDA tensors only; it checks them, allocates the output and launches
on PyTorch's current stream.  The pools may be any strided [P, T, Hkv, D]
view (one layer of the engine's [L, P, T, Hkv, D] pool): they are read
through their strides, never copied.  ``launches`` counts the kernel
launches of this process.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build

launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
MAX_PAGE_TOKENS = 64      # one page must fit the kernel's staging tile
MAX_GROUP = 32            # query heads per kv head held in shared memory


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.paged_attention_fwd.argtypes = (
        [P] * 6 + [I] * 7 + [LL] * 14 + [ctypes.c_float, P])
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
    for name, t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged_attention_fwd: {name} is not a CUDA "
                             "tensor on q's device")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_attention_fwd: dtypes q {q.dtype} k "
                         f"{k_pages.dtype} v {v_pages.dtype}; one of "
                         f"{list(DTYPES)}")
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
    if k_pages.shape[3] != d or d not in HEAD_DIMS:
        raise ValueError(f"paged_attention_fwd: head dim {d} vs pool "
                         f"{k_pages.shape[3]}; one of {HEAD_DIMS}")
    if h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"paged_attention_fwd: {h} heads over {hkv} kv "
                         f"heads (at most {MAX_GROUP} per kv head)")
    if not 1 <= t <= MAX_PAGE_TOKENS:
        raise ValueError(f"paged_attention_fwd: {t} tokens per page, at "
                         f"most {MAX_PAGE_TOKENS}")
    if tuple(page_table.shape) != (b, pp) or tuple(lengths.shape) != (b,):
        raise ValueError(f"paged_attention_fwd: table "
                         f"{tuple(page_table.shape)} lengths "
                         f"{tuple(lengths.shape)} for batch {b}")
    page_table = page_table.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or pp == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.paged_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], b, h, hkv, d, t, pp,
            *q.stride(), *k_pages.stride(), *v_pages.stride(),
            *out.stride(), 1.0 / np.sqrt(d), stream)
    _build.check(lib, code, "paged_attention_fwd")
    launches += 1
    return out
