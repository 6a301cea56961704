"""Launch wrapper of the hand-written CUDA flash-attention forward
(``src/repro_torch/csrc/flash_attention.cu``).

Takes CUDA tensors only; it checks them, allocates the output and launches
on PyTorch's current stream.  ``launches`` counts the kernel launches of
this process, so a run can show which path went through the kernel.

bf16 inputs run the tensor-core kernel, which reads q/k/v by TMA: each view
must have a unit last stride and 16-byte aligned base and strides
(`tma_view_problem`).  A view that fails raises ``ValueError``; nothing is
copied.  The model's views, and slices of a fused projection, pass.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import _build

launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = (
        [P, P, P, P] + [I] * 7 + [LL] * 16 + [I, I, ctypes.c_float, I, I,
                                              P])
    lib.flash_attention_fwd.restype = I
    return lib


class Plan(NamedTuple):
    block_q: int      # q rows per block
    block_k: int      # kv rows per tile
    grid: tuple       # (q tiles, heads, batch)


def plan(dtype: torch.dtype, b: int, sq: int, h: int, d: int) -> Plan:
    """The tiles and grid of one launch, as ``flash_attention.cu`` is built
    for them: bf16 takes 128 q rows (two warpgroups) and 64-row kv tiles,
    fp32 64 q rows and 32-row kv tiles, at every head dim."""
    bq, bk = (128, 64) if dtype == torch.bfloat16 else (64, 32)
    return Plan(bq, bk, (-(-sq // bq), h, b))


def tma_view_problem(shape: Sequence[int], strides: Sequence[int],
                     itemsize: int, data_ptr: int) -> Optional[str]:
    """Why TMA cannot read a view with these element strides, or None:
    the last stride must be 1, the base and the other strides 16-byte
    aligned (and below 2**40 bytes)."""
    if strides[-1] != 1:
        return f"last stride {strides[-1]}, not 1"
    if data_ptr % 16:
        return f"base address {data_ptr:#x} is not 16-byte aligned"
    for dim, st in zip(shape[:-1], strides[:-1]):
        nbytes = st * itemsize
        if dim > 1 and (nbytes % 16 or not 0 < nbytes < 1 << 40):
            return f"stride of {st} elements ({nbytes} bytes) is not a " \
                   "positive multiple of 16 bytes"
    return None


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        sliding_window: Optional[int] = None
                        ) -> torch.Tensor:
    """q: [B, Sq, H, D]; k/v: [B, Skv, Hkv, D], any strides → [B, Sq, H, D]
    in q's dtype."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention_fwd: {name} is not a CUDA "
                             "tensor")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_fwd: {name} must be 4-D, "
                             f"got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention_fwd: q, k, v differ in dtype "
                             "or device")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention_fwd: dtype {q.dtype} not in "
                         f"{list(DTYPES)}")
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if h % hkv:
        raise ValueError(f"flash_attention_fwd: {h} heads over {hkv} kv "
                         "heads")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"flash_attention_fwd: window {sliding_window}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            why = tma_view_problem(t.shape, t.stride(), t.element_size(),
                                   t.data_ptr())
            if why:
                raise ValueError(f"flash_attention_fwd: {name} cannot be "
                                 f"read by TMA: {why}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    tiles = plan(q.dtype, b, sq, h, d)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], b, h, hkv, sq, skv, d,
            *q.stride(), *k.stride(), *v.stride(), *out.stride(),
            int(causal), sliding_window or 0, 1.0 / np.sqrt(d),
            tiles.block_q, tiles.block_k, stream)
    _build.check(lib, code, "flash_attention_fwd")
    launches += 1
    return out
