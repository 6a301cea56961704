"""Launch wrapper of the hand-written CUDA flash-attention forward
(``src/repro_torch/csrc/flash_attention.cu``).

Takes CUDA tensors only; it checks them, allocates the output and launches
on PyTorch's current stream.  ``launches`` counts the kernel launches of
this process, so a run can show which path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

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
        [P, P, P, P] + [I] * 7 + [LL] * 16 + [I, I, ctypes.c_float, P])
    lib.flash_attention_fwd.restype = I
    return lib


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
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], b, h, hkv, sq, skv, d,
            *q.stride(), *k.stride(), *v.stride(), *out.stride(),
            int(causal), sliding_window or 0, 1.0 / np.sqrt(d), stream)
    _build.check(lib, code, "flash_attention_fwd")
    launches += 1
    return out
