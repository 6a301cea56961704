"""Public paged-attention op: the CUDA kernel on CUDA tensors, its plain
version on CPU tensors.

Layout contract with the engine: q [B, H, D]; the pools are one layer of
the engine's pool, [P, T, Hkv, D], passed as the strided view it is.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import paged_attention_plain


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """q: [B, H, D]; k_pages/v_pages: [P, T, Hkv, D]; page_table: [B, PP]
    int32 (-1 = unused); lengths: [B] int32 → [B, H, D]."""
    if q.is_cuda:
        return kernel.paged_attention_fwd(q, k_pages, v_pages, page_table,
                                          lengths)
    return paged_attention_plain(q, k_pages, v_pages, page_table, lengths)
