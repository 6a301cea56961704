"""Public flash-attention op: the CUDA kernel on CUDA tensors, its plain
version on CPU tensors, with a backward that recomputes through the plain
version (the TPU kernel has no backward kernel either).

Layout contract with the models: q [B, S, H, D], k/v [B, S, Hkv, D].
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel
from .ref import attention_plain


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.sliding_window = causal, sliding_window
        if q.is_cuda:
            return kernel.flash_attention_fwd(
                q, k, v, causal=causal, sliding_window=sliding_window)
        return attention_plain(q, k, v, causal=causal,
                               sliding_window=sliding_window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_plain(*inputs, causal=ctx.causal,
                                  sliding_window=ctx.sliding_window)
            dq, dk, dv = torch.autograd.grad(out, inputs, g)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sliding_window: Optional[int] = None) -> torch.Tensor:
    """q: [B, Sq, H, D]; k/v: [B, Skv, Hkv, D] → [B, Sq, H, D]."""
    return _FlashAttention.apply(q, k, v, causal, sliding_window)
