"""Shared building blocks of the port's dense models (plain PyTorch).

Functional, as in the JAX package: params are nested dicts of tensors and
these functions only compute.  Layouts follow the JAX package: activations
[B, S, d], heads [B, S, H, D].
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .common import to_dtype

NEG_INF = -1e30


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if x.dtype == dtype else x.to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


# ----------------------------------------------------------------- rotary
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2,
                                      dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _device_freqs(head_dim: int, theta: float,
                  device: torch.device) -> torch.Tensor:
    # made once: a host-to-device copy per call would stall the stream
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = _device_freqs(d, theta, x.device)             # [D/2]
    angles = positions[..., :, None].float() * freqs      # [..., S, D/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sliding_window: Optional[int] = None,
              impl: str = "xla") -> torch.Tensor:
    """Scaled-dot-product GQA attention.

    q: [B, Sq, H, D]; k/v: [B, Skv, Hkv, D].  ``impl`` selects the einsum
    path ("xla"), the flash kernel ("pallas": the CUDA kernel on a CUDA
    tensor, its plain version on a CPU one) or the kernel's plain version
    ("pallas_interpret"), for train/prefill shapes.  Unlike the JAX
    package's pallas path, the kernel paths keep ``sliding_window``.
    """
    if impl.startswith("pallas") and q.shape[1] > 1 \
            and q.shape[1] == k.shape[1]:
        if impl == "pallas":
            from repro_torch.kernels.flash_attention import flash_attention
            return flash_attention(q, k, v, causal=causal,
                                   sliding_window=sliding_window)
        from repro_torch.kernels.flash_attention import attention_plain
        return attention_plain(q, k, v, causal=causal,
                               sliding_window=sliding_window)

    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    # grouped GQA: fold query heads over their kv head, no repeated K/V
    qg = q.reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * (1.0 / np.sqrt(d))
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if sliding_window is not None:
        mask &= kpos > qpos - sliding_window
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h, d)


def qkv(params, y: torch.Tensor, cfg, positions: torch.Tensor):
    """Projections of the normed input y [B, S, d] to rotated q
    [B, S, H, D], rotated k and v [B, S, Hkv, D]; positions [B|1, S]."""
    dt = to_dtype(cfg.compute_dtype)
    hd = cfg.head_dim_
    b, s, _ = y.shape

    def proj(name, heads):
        out = (y @ cast(params[name], dt)).view(b, s, heads, hd)
        if cfg.qkv_bias and f"{name}_b" in params:
            out = out + cast(params[f"{name}_b"], dt).view(heads, hd)
        return out

    q = apply_rope(proj("wq", cfg.n_heads), positions, cfg.rope_theta)
    k = apply_rope(proj("wk", cfg.n_kv_heads), positions, cfg.rope_theta)
    return q, k, proj("wv", cfg.n_kv_heads)


def attn_out(params, attn: torch.Tensor, cfg) -> torch.Tensor:
    """Output projection of attention heads [B, S, H, D] → [B, S, d]."""
    return attn.flatten(2) @ cast(params["wo"], to_dtype(cfg.compute_dtype))


def gqa_block(params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              sliding_window: Optional[int] = None) -> torch.Tensor:
    """Pre-norm GQA attention block over a full sequence (train/prefill;
    the cache branch of the JAX block comes with the ring-cache slice)."""
    y = rms_norm(x, params["ln"], cfg.norm_eps)
    q, k, v = qkv(params, y, cfg, positions)
    attn = attention(q, k, v, causal=True, sliding_window=sliding_window,
                     impl=cfg.attn_impl)
    return attn_out(params, attn, cfg)


# ------------------------------------------------------------------- MLPs
def swiglu(params, x: torch.Tensor, cfg) -> torch.Tensor:
    dt = to_dtype(cfg.compute_dtype)
    y = rms_norm(x, params["ln"], cfg.norm_eps)
    h = F.silu(y @ cast(params["w_gate"], dt)) * (y @ cast(params["w_up"],
                                                          dt))
    return h @ cast(params["w_down"], dt)


# -------------------------------------------------------------- embeddings
def embed(params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    # gather, then cast: the same values as casting the table first
    return cast(params["embedding"][tokens], to_dtype(cfg.compute_dtype))


def unembed(params, x: torch.Tensor, cfg) -> torch.Tensor:
    w = params.get("unembedding", params["embedding"])
    return x @ cast(w, to_dtype(cfg.compute_dtype)).T
