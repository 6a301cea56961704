"""Plain PyTorch version of the flash-attention kernel.

Same function and conventions as the CUDA kernel: fp32 logits and softmax,
masked logits -1e30 with weight 0, denominator clamped at 1e-30 (a row
with no visible key gives 0), output in q's dtype.  CPU tensors take this
path, and the card's kernel is held against it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sliding_window: Optional[int] = None) -> torch.Tensor:
    """q: [B, Sq, H, D]; k/v: [B, Skv, Hkv, D] with H % Hkv == 0."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) \
        * (1.0 / np.sqrt(d))
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if sliding_window is not None:
        mask &= kpos > qpos - sliding_window
    logits = logits.masked_fill(~mask, NEG_INF)
    # the max only shifts the exponent; keep it out of the gradient
    m = logits.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(logits - m) * mask
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / denom, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)
