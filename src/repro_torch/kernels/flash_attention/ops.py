"""Public flash-attention op: the CUDA kernels on CUDA tensors, their plain
versions on CPU tensors.

The backward of a bf16 op on the card is the hand-written kernel
(``kernel.flash_attention_bwd``), fed by the log-sum-exp that the forward
saves when an input needs a gradient; a forward that needs none (prefill,
any ``no_grad`` call) saves nothing.  fp32 on the card and every CPU
tensor differentiate the plain version: no benchmarked path trains in fp32
on the card, and the TPU kernel has no backward kernel either.

Layout contract with the models: q [B, S, H, D], k/v [B, S, Hkv, D].
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import kernel
from .ref import attention_plain


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the kernels (a CUDA tensor)."""
    return t.is_cuda


def _saves_lse(q: torch.Tensor, needs_input_grad: Sequence[bool]) -> bool:
    """Whether the forward keeps its log-sum-exp for the backward kernel:
    bf16 on the card, and some of q, k, v needs a gradient."""
    return _on_card(q) and q.dtype == torch.bfloat16 \
        and any(needs_input_grad[:3])


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window):
        ctx.causal, ctx.sliding_window = causal, sliding_window
        if _saves_lse(q, ctx.needs_input_grad):
            out, lse = kernel.flash_attention_fwd(
                q, k, v, causal=causal, sliding_window=sliding_window,
                return_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        if _on_card(q):
            return kernel.flash_attention_fwd(
                q, k, v, causal=causal, sliding_window=sliding_window)
        return attention_plain(q, k, v, causal=causal,
                               sliding_window=sliding_window)

    @staticmethod
    def backward(ctx, g):
        q, k, v, *saved = ctx.saved_tensors
        if saved:
            out, lse = saved
            dq, dk, dv = kernel.flash_attention_bwd(
                q, k, v, out, lse, g, causal=ctx.causal,
                sliding_window=ctx.sliding_window)
            return dq, dk, dv, None, None
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
