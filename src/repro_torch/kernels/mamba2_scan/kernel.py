"""Launch wrapper of the hand-written CUDA SSD scan
(``src/repro_torch/csrc/mamba2_scan.cu``).

Takes CUDA fp32 tensors only; it checks them, allocates the outputs and
launches on PyTorch's current stream.  xw, dta, b, c are read through
their strides and y is allocated with xw's layout, so a caller holding
[B, S, H, P] data passes its [B, H, S, P] transposed view and gets y back
as the same kind of view, with no copy either way.  ``launches`` counts the
wrapper's calls that launched the kernels (three launches each: chunk
states, the state pass, chunk outputs).

`plan` sizes a call: the padded width of the tiles, the heads per block
and the fp32 scratch of chunk states (B·H·C·P·N) and chunk decays
(B·H·C), which the wrapper allocates with ``torch.empty``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build

launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mamba2_scan")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_fwd.argtypes = [P] * 9 + [I] * 8 + [LL] * 17 + [P]
    lib.ssd_scan_fwd.restype = I
    return lib


TILES = (16, 32, 64)      # the padded P and N widths the kernels are built for
HEADS_PER_BLOCK = 8


class Plan(NamedTuple):
    chunk: int                 # Q
    n_chunks: int              # C = S / Q
    tile: int                  # P and N padded to this width
    heads_per_block: int
    grid: tuple                # (chunks, batch, head groups)
    states_shape: tuple        # [B, H, C, P, N] fp32 scratch
    decay_shape: tuple         # [B, H, C] fp32 scratch

    @property
    def scratch_bytes(self) -> int:
        return 4 * (int(np.prod(self.states_shape))
                    + int(np.prod(self.decay_shape)))


def plan(bsz: int, h: int, s: int, p: int, n: int, chunk: int) -> Plan:
    """The launch plan of one call; raises ``ValueError`` for a sequence
    that is not a multiple of min(chunk, S) or a P or N above 64."""
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(f"ssd_scan_fwd: seq {s} is not a multiple of "
                         f"chunk {q}")
    tile = next((t for t in TILES if max(p, n) <= t), None)
    if tile is None:
        raise ValueError(f"ssd_scan_fwd: P={p}, N={n}; the kernel takes "
                         f"widths up to {TILES[-1]}")
    hb = min(HEADS_PER_BLOCK, h)
    nc = s // q
    return Plan(q, nc, tile, hb, (nc, bsz, -(-h // hb)),
                (bsz, h, nc, p, n), (bsz, h, nc))


def ssd_scan_fwd(xw: torch.Tensor, dta: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, *, chunk: int = 128,
                 s0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xw: [B, H, S, P]; dta: [B, H, S]; b/c: [B, S, N]; s0: [B, H, P, N]
    or None; all fp32, any strides.  Returns (y [B, H, S, P], s_final
    [B, H, P, N] contiguous), both fp32.  S % min(chunk, S) must be 0 and
    P, N at most 64.  A chunk whose tiles do not fit one block's shared
    memory raises the launch's CUDA error."""
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
    pl = plan(bsz, h, s, p, n, chunk)
    y = torch.empty_like(xw)                     # xw's strides, if dense
    s_final = torch.empty((bsz, h, p, n), dtype=torch.float32,
                          device=xw.device)
    states = torch.empty(pl.states_shape, dtype=torch.float32,
                         device=xw.device)
    decay = torch.empty(pl.decay_shape, dtype=torch.float32,
                        device=xw.device)
    s0 = s0.contiguous() if s0 is not None else None
    lib = _lib()
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ssd_scan_fwd(
            xw.data_ptr(), dta.data_ptr(), b.data_ptr(), c.data_ptr(),
            s0.data_ptr() if s0 is not None else None, y.data_ptr(),
            s_final.data_ptr(), states.data_ptr(), decay.data_ptr(), bsz, h,
            s, p, n, pl.chunk, pl.tile, pl.heads_per_block, *xw.stride(),
            *dta.stride(), *b.stride(), *c.stride(), *y.stride(), stream)
    _build.check(lib, code, "ssd_scan_fwd")
    launches += 1
    return y, s_final
