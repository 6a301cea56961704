"""Launch wrappers of the hand-written CUDA flash-attention forward
(``src/repro_torch/csrc/flash_attention.cu``) and backward
(``csrc/flash_attention_bwd.cu``).

They take CUDA tensors only; they check them, allocate the outputs and
scratch and launch on PyTorch's current stream.  ``launches`` counts the
forward's calls in this process and ``bwd_launches`` the backward's, so a
run can show which path went through the kernels.

bf16 inputs run the tensor-core kernels, which read q/k/v by TMA: each view
must have a unit last stride and 16-byte aligned base and strides
(`tma_view_problem`).  A q, k or v that fails raises ``ValueError``; the
model's views, and slices of a fused projection, pass.  The backward also
reads ``out`` and ``dout`` 16 bytes at a time and copies either once if it
cannot (an expanded gradient, say).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import _build

launches = 0
bwd_launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = (
        [P] * 5 + [I] * 7 + [LL] * 16 + [I, I, ctypes.c_float, I, I, P])
    lib.flash_attention_fwd.restype = I
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd.argtypes = (
        [P] * 11 + [I] * 7 + [P, I, I, ctypes.c_float, I, I, P])
    lib.flash_attention_bwd.restype = I
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


class PlanBwd(NamedTuple):
    block_q: int      # q rows per tile
    block_kv: int     # kv rows per block
    sq_pad: int       # Sq rounded up to whole q tiles (dQ's fp32 rows)
    grid: tuple       # (kv tiles, kv heads, batch)


def plan_bwd(b: int, sq: int, skv: int, hkv: int) -> PlanBwd:
    """The tiles and grid of the backward, as ``flash_attention_bwd.cu`` is
    built for them at every head dim: a block holds 128 kv rows (two
    warpgroups of 64) of one kv head and walks 64-row q tiles."""
    bq, bkv = 64, 128
    return PlanBwd(bq, bkv, -(-sq // bq) * bq, (-(-skv // bkv), hkv, b))


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
                        sliding_window: Optional[int] = None,
                        return_lse: bool = False):
    """q: [B, Sq, H, D]; k/v: [B, Skv, Hkv, D], any strides → [B, Sq, H, D]
    in q's dtype.  With ``return_lse`` (bf16 only) also each row's
    log-sum-exp of the scaled logits, fp32 [B, H, Sq] (+inf where no key
    is visible), which the backward kernel needs."""
    global launches
    if return_lse and q.dtype != torch.bfloat16:
        raise ValueError("flash_attention_fwd: only the bf16 kernel saves "
                         f"a log-sum-exp, not {q.dtype}")
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
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    tiles = plan(q.dtype, b, sq, h, d)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            DTYPES[q.dtype], b, h, hkv, sq, skv, d,
            *q.stride(), *k.stride(), *v.stride(), *out.stride(),
            int(causal), sliding_window or 0, 1.0 / np.sqrt(d),
            tiles.block_q, tiles.block_k, stream)
    _build.check(lib, code, "flash_attention_fwd")
    launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        sliding_window: Optional[int] = None) -> tuple:
    """The gradients (dq, dk, dv) of the forward's ``out`` against ``dout``,
    bf16, from the forward's ``lse`` (``return_lse=True``).  q, k, v as the
    forward took them; ``out`` and ``dout`` are copied once if they are not
    read 16 bytes at a time (an expanded gradient, say)."""
    global bwd_launches
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention_bwd: {name} is not a CUDA "
                             "tensor")
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} is "
                             f"{t.dtype} on {t.device}; the kernel takes "
                             "bf16 on q's device")
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d \
            or out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} out "
                         f"{tuple(out.shape)} dout {tuple(dout.shape)}")
    if d not in HEAD_DIMS or h % hkv:
        raise ValueError(f"flash_attention_bwd: head dim {d}, {h} heads "
                         f"over {hkv}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype}, want contiguous fp32 {(b, h, sq)}")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"flash_attention_bwd: window {sliding_window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        why = tma_view_problem(t.shape, t.stride(), t.element_size(),
                               t.data_ptr())
        if why:
            raise ValueError(f"flash_attention_bwd: {name} cannot be read "
                             f"by TMA: {why}")
    if tma_view_problem(out.shape, out.stride(), out.element_size(),
                        out.data_ptr()):
        out = out.contiguous()
    if tma_view_problem(dout.shape, dout.stride(), dout.element_size(),
                        dout.data_ptr()):
        dout = dout.contiguous()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, skv, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    tiles = plan_bwd(b, sq, skv, hkv)
    aux = torch.empty((b, h, 2, tiles.sq_pad), dtype=torch.float32,
                      device=q.device)
    # zeroed by the kernels' first pass
    dq_acc = torch.empty((b, h, tiles.sq_pad, d), dtype=torch.float32,
                         device=q.device)
    strides = (ctypes.c_longlong * 32)(*(
        st for t in (q, k, v, out, dout, dq, dk, dv) for st in t.stride()))
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), aux.data_ptr(),
            dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, hkv, sq, skv, d, tiles.sq_pad, strides, int(causal),
            sliding_window or 0, 1.0 / np.sqrt(d), tiles.block_q,
            tiles.block_kv, stream)
    _build.check(lib, code, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv
