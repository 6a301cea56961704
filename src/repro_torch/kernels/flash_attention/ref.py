"""Plain PyTorch versions of the flash-attention kernels.

Same function and conventions as the CUDA kernels: fp32 logits and softmax,
masked logits -1e30 with weight 0, denominator clamped at 1e-30 (a row
with no visible key gives 0), output in q's dtype.  CPU tensors take the
forward, and the card's kernels are held against both.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def _mask(sq: int, skv: int, causal: bool, sliding_window: Optional[int],
          device) -> torch.Tensor:
    """[Sq, Skv] visibility, causal aligned top-left (key k <= query q)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if sliding_window is not None:
        mask &= kpos > qpos - sliding_window
    return mask


def _logits(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor):
    """q grouped as [B, Sq, Hkv, G, D] in fp32, and the masked scaled
    logits [B, Hkv, G, Sq, Skv]."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) \
        * (1.0 / np.sqrt(d))
    return qg, logits.masked_fill(~mask, NEG_INF)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sliding_window: Optional[int] = None,
                    return_lse: bool = False):
    """q: [B, Sq, H, D]; k/v: [B, Skv, Hkv, D] with H % Hkv == 0.  With
    ``return_lse`` also each row's log-sum-exp of the scaled logits over
    its visible keys, fp32 [B, H, Sq], +inf where none is visible (so that
    exp(logit - lse) gives such a row weight 0), as the forward kernel
    saves it."""
    b, sq, h, d = q.shape
    mask = _mask(sq, k.shape[1], causal, sliding_window, q.device)
    _, logits = _logits(q, k, mask)
    # the max only shifts the exponent; keep it out of the gradient
    m = logits.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(logits - m) * mask
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / denom, v.float())
    out = out.reshape(b, sq, h, d).to(q.dtype)
    if not return_lse:
        return out
    seen = mask.any(dim=-1)
    lse = torch.where(seen, (m + denom.log()).squeeze(-1), float("inf"))
    return out, lse.reshape(b, h, sq)


def attention_plain_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        sliding_window: Optional[int] = None) -> tuple:
    """The backward kernel's algorithm in fp32: P recomputed from the
    forward's ``lse`` ([B, H, Sq]), delta = rowsum(dO ∘ O), dS = P ∘ (dP −
    delta), then dQ = scale · dS K, dK = scale · dSᵀ Q, dV = Pᵀ dO.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / np.sqrt(d)
    mask = _mask(sq, skv, causal, sliding_window, q.device)
    qg, logits = _logits(q, k, mask)
    lse_g = lse.float().reshape(b, hkv, g, sq, 1)
    p = torch.exp(logits - lse_g) * mask               # [b, hkv, g, q, k]
    dog = dout.reshape(b, sq, hkv, g, d).float()
    og = out.reshape(b, sq, hkv, g, d).float()
    delta = (dog * og).sum(-1).permute(0, 2, 3, 1)     # [b, hkv, g, q]
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
