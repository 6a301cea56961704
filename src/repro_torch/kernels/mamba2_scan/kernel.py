"""Launch wrapper of the hand-written CUDA SSD scan
(``src/repro_torch/csrc/mamba2_scan.cu``).

Takes CUDA fp32 tensors only; it checks them, allocates the outputs and
launches on PyTorch's current stream.  xw, dta, b, c are read through
their strides and y is allocated with xw's layout, so a caller holding
[B, S, H, P] data passes its [B, H, S, P] transposed view and gets y back
as the same kind of view, with no copy either way.  ``launches`` counts the
kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _build

launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mamba2_scan")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_fwd.argtypes = [P] * 7 + [I] * 6 + [LL] * 17 + [P]
    lib.ssd_scan_fwd.restype = I
    return lib


def ssd_scan_fwd(xw: torch.Tensor, dta: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, *, chunk: int = 128,
                 s0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xw: [B, H, S, P]; dta: [B, H, S]; b/c: [B, S, N]; s0: [B, H, P, N]
    or None; all fp32, any strides.  Returns (y [B, H, S, P], s_final
    [B, H, P, N] contiguous), both fp32.  S % min(chunk, S) must be 0.  A
    (P, N, chunk) whose tiles do not fit one block's shared memory raises
    the launch's CUDA error."""
    global launches
    tensors = [("xw", xw), ("dta", dta), ("b", b), ("c", c)]
    if s0 is not None:
        tensors.append(("s0", s0))
    for name, t in tensors:
        if not t.is_cuda or t.device != xw.device:
            raise ValueError(f"ssd_scan_fwd: {name} is not a CUDA tensor on "
                             "xw's device")
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_scan_fwd: {name} is {t.dtype}; the kernel "
                             "takes float32")
    if xw.dim() != 4:
        raise ValueError(f"ssd_scan_fwd: xw must be [B, H, S, P], got "
                         f"{tuple(xw.shape)}")
    bsz, h, s, p = xw.shape
    n = b.shape[-1]
    if tuple(dta.shape) != (bsz, h, s) or tuple(b.shape) != (bsz, s, n) \
            or tuple(c.shape) != (bsz, s, n):
        raise ValueError(f"ssd_scan_fwd: shapes xw {tuple(xw.shape)} dta "
                         f"{tuple(dta.shape)} b {tuple(b.shape)} c "
                         f"{tuple(c.shape)}")
    if s0 is not None and tuple(s0.shape) != (bsz, h, p, n):
        raise ValueError(f"ssd_scan_fwd: s0 {tuple(s0.shape)}, want "
                         f"{(bsz, h, p, n)}")
    if min(bsz, h, s, p, n) < 1:
        raise ValueError(f"ssd_scan_fwd: empty input, xw {tuple(xw.shape)} "
                         f"N={n}")
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(f"ssd_scan_fwd: seq {s} is not a multiple of "
                         f"chunk {q}")
    y = torch.empty_like(xw)                     # xw's strides, if dense
    s_final = torch.empty((bsz, h, p, n), dtype=torch.float32,
                          device=xw.device)
    s0 = s0.contiguous() if s0 is not None else None
    lib = _lib()
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ssd_scan_fwd(
            xw.data_ptr(), dta.data_ptr(), b.data_ptr(), c.data_ptr(),
            s0.data_ptr() if s0 is not None else None, y.data_ptr(),
            s_final.data_ptr(), bsz, h, s, p, n, q, *xw.stride(),
            *dta.stride(), *b.stride(), *c.stride(), *y.stride(), stream)
    _build.check(lib, code, "ssd_scan_fwd")
    launches += 1
    return y, s_final
