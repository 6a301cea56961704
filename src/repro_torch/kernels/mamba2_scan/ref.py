"""Plain PyTorch versions of the SSD-scan kernel.

`ssd_scan_plain` computes what the CUDA kernel computes, in the kernel's
layout and by the same chunked algorithm: per chunk of Q steps, with
l = cumsum(dta),

  y  = tril(C Bᵀ ⊙ exp(lᵢ − lⱼ)) · XW + exp(l) ⊙ (C · Sᵀ)
  S' = exp(l_Q)·S + Σⱼ exp(l_Q − lⱼ)·XWⱼ ⊗ Bⱼ

The decay exp(lᵢ − lⱼ) is masked before it is exponentiated: above the
diagonal lᵢ − lⱼ is positive and can be large, and exp of it would be inf.

`ssd_recurrent_ref` is the port's copy of the JAX package's oracle, the
token-by-token recurrence, for the tests.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_scan_plain(xw: torch.Tensor, dta: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, *, chunk: int = 128,
                   s0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xw: [B, H, S, P]; dta: [B, H, S]; b/c: [B, S, N]; s0: [B, H, P, N]
    or None (zeros).  Returns (y [B, H, S, P] in xw's dtype, s_final
    [B, H, P, N] fp32).  S must be a multiple of min(chunk, S)."""
    bsz, h, s, p = xw.shape
    n = b.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} is not a multiple of chunk {q}")
    nc = s // q
    xwc = xw.float().reshape(bsz, h, nc, q, p)
    bc = b.float().reshape(bsz, nc, q, n)
    cc = c.float().reshape(bsz, nc, q, n)
    lcum = dta.float().reshape(bsz, h, nc, q).cumsum(dim=-1)   # [B,H,C,Q]

    # intra-chunk: M[i, j] = (c_i·b_j)·exp(l_i − l_j) for j ≤ i
    g = torch.einsum("bcin,bcjn->bcij", cc, bc)               # [B,C,Q,Q]
    tri = torch.ones((q, q), dtype=torch.bool, device=xw.device).tril()
    ldiff = lcum[..., :, None] - lcum[..., None, :]           # [B,H,C,Q,Q]
    m = torch.exp(ldiff.masked_fill(~tri, float("-inf"))) * g[:, None]
    y = torch.einsum("bhcij,bhcjp->bhcip", m, xwc)

    # per-chunk state contribution and decay, then the carried state
    decay_end = torch.exp(lcum[..., -1:] - lcum)              # [B,H,C,Q]
    chunk_state = torch.einsum("bhcj,bhcjp,bcjn->bhcpn", decay_end, xwc, bc)
    chunk_decay = torch.exp(lcum[..., -1])                    # [B,H,C]
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=xw.device)
             if s0 is None else s0.float())
    starts = []
    # unbound once: an index per chunk would have each index's backward
    # write a zero gradient of the whole of chunk_state, O(C^2) bytes
    for decay, add in zip(chunk_decay.unbind(2), chunk_state.unbind(2)):
        starts.append(state)
        state = state * decay[:, :, None, None] + add
    s_starts = torch.stack(starts, dim=2)                     # [B,H,C,P,N]

    # inter-chunk: exp(l_i)·(c_i · S_startᵀ)
    y = y + torch.exp(lcum)[..., None] * torch.einsum(
        "bcin,bhcpn->bhcip", cc, s_starts)
    return y.reshape(bsz, h, s, p).to(xw.dtype), state


def ssd_recurrent_ref(xw: torch.Tensor, dta: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, s0: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token SSD recurrence (fp32), in the JAX oracle's layout.

    xw: [B, S, H, P] (x · dt); dta: [B, S, H] (dt · A, A < 0); b/c:
    [B, S, N].  Returns (y [B, S, H, P], s_final [B, H, P, N]).
    """
    bsz, s, h, p = xw.shape
    n = b.shape[-1]
    xw, dta, b, c = xw.float(), dta.float(), b.float(), c.float()
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=xw.device)
             if s0 is None else s0.float())
    ys = []
    for t in range(s):
        state = state * torch.exp(dta[:, t])[:, :, None, None] \
            + torch.einsum("bhp,bn->bhpn", xw[:, t], b[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=1), state
