"""Public SSD-scan op, with the model's calling convention (the contract
of ``mamba2.ssd_chunked``): the CUDA kernel on CUDA tensors, its plain
version on CPU tensors.

The elementwise prologue (xw = x·dt, dta = dt·A with A = −exp(a_log)) and
the D skip are plain PyTorch around the kernel, as in the JAX package.
The kernel reads the [B, S, H, ·] prologue outputs as transposed views and
writes y in the same layout, so no transpose is copied.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel
from .ref import ssd_scan_plain


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor, *,
             chunk: int = 128, s0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh: [B, S, H, P]; dt: [B, S, H] (post-softplus); a_log, d_skip: [H];
    b/c: [B, S, N]; s0: [B, H, P, N] or None.  Returns (y [B, S, H, P],
    s_final [B, H, P, N]), both fp32; y includes the D·x skip.  S must be a
    multiple of min(chunk, S)."""
    dt = dt.float()
    dta = dt * -torch.exp(a_log.float())                  # [B, S, H]
    xf = xh.float()
    xw = xf * dt[..., None]                               # [B, S, H, P]
    args = (xw.transpose(1, 2), dta.transpose(1, 2), b.float(), c.float())
    s0 = s0.float() if s0 is not None else None
    if xh.is_cuda:
        y, s_final = kernel.ssd_scan_fwd(*args, chunk=chunk, s0=s0)
    else:
        y, s_final = ssd_scan_plain(*args, chunk=chunk, s0=s0)
    y = y.transpose(1, 2) + d_skip.float()[:, None] * xf
    return y, s_final
