"""Plain PyTorch version of the paged-attention kernel.

Same function and conventions as the CUDA kernel: table entries of -1 read
page 0, positions at or past the length get weight 0, fp32 softmax with the
denominator clamped at 1e-30, output in q's dtype.  It gathers the pages
(the metadata-list walk, materialized); the kernel reads them in place.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """q: [B, H, D]; k_pages/v_pages: [P, T, Hkv, D] (any strides);
    page_table: [B, PP] (-1 = unused); lengths: [B].  Returns [B, H, D]."""
    b, h, d = q.shape
    _, t, hkv, _ = k_pages.shape
    pp = page_table.shape[1]
    tbl = page_table.long().clamp_min(0)
    k = k_pages[tbl].reshape(b, pp * t, hkv, d).float()   # [B, S, Hkv, D]
    v = v_pages[tbl].reshape(b, pp * t, hkv, d).float()
    qg = q.reshape(b, hkv, h // hkv, d).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k) * (1.0 / np.sqrt(d))
    pos = torch.arange(pp * t, device=q.device)
    mask = (pos[None, :] < lengths[:, None])[:, None, None, :]
    logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True)) * mask
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgs,bshd->bhgd", p / denom, v)
    return out.reshape(b, h, d).to(q.dtype)
