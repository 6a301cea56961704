"""Public SSD-scan op, with the model's calling convention (the contract
of ``mamba2.ssd_chunked``): the CUDA kernel on CUDA tensors, its plain
version on CPU tensors, with a backward that recomputes through the plain
version (the JAX package differentiates its jnp ``ssd_chunked``; no
backward kernel exists on either side).

The elementwise prologue (xw = x·dt, dta = dt·A with A = −exp(a_log)) and
the D skip are plain PyTorch around the scan, as in the JAX package, and
autograd differentiates them as they are.  The scan reads the [B, S, H, ·]
prologue outputs as transposed views and writes y in the same layout, so
no transpose is copied.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel
from .ref import ssd_scan_plain


class _SSDScan(torch.autograd.Function):
    """(xw, dta, b, c, s0) → (y, s_final) in the kernel's layout; s0 may
    be None.  Gradients for xw, dta, b, c and s0."""

    @staticmethod
    def forward(ctx, xw, dta, b, c, s0, chunk):
        ctx.save_for_backward(xw, dta, b, c, s0)
        ctx.chunk = chunk
        if xw.is_cuda:
            return kernel.ssd_scan_fwd(xw, dta, b, c, chunk=chunk, s0=s0)
        return ssd_scan_plain(xw, dta, b, c, chunk=chunk, s0=s0)

    @staticmethod
    def backward(ctx, gy, gs):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_()
                      for t in saved]
            y, s_final = ssd_scan_plain(*inputs[:4], chunk=ctx.chunk,
                                        s0=inputs[4])
            grads = iter(torch.autograd.grad(
                (y, s_final), [t for t in inputs if t is not None],
                (gy, gs)))
        return (*(None if t is None else next(grads) for t in inputs),
                None)


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
    s0 = s0.float() if s0 is not None else None
    y, s_final = _SSDScan.apply(xw.transpose(1, 2), dta.transpose(1, 2),
                                b.float(), c.float(), s0, chunk)
    y = y.transpose(1, 2) + d_skip.float()[:, None] * xf
    return y, s_final
