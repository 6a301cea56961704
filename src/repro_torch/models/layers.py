"""Shared building blocks of the port's models (plain PyTorch): norms,
RoPE, attention (full-sequence and against the ring KV cache), MLP,
embeddings and the training loss.

Functional, as in the JAX package: params are nested dicts of tensors and
these functions only compute.  Layouts follow the JAX package: activations
[B, S, d], heads [B, S, H, D].
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, key_pos: torch.Tensor,
                     qpos: torch.Tensor, *,
                     sliding_window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against a ring-buffer cache.

    q: [B, 1, H, D]; k_cache/v_cache: [B, W, Hkv, D]; key_pos: [B, W]
    (absolute position written to each slot, -1 = empty); qpos: [B].
    Keys are valid by position, not by slot order, so full caches (W =
    max_len) and sliding-window caches (W = window) are one code path.
    GQA is grouped: the cache is never repeated over query heads.  Both
    products read the cache in its storage dtype (an fp32 copy of the
    whole cache per call would cost more than the attention itself); the
    logits are taken to fp32 for the mask and the softmax.
    """
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).to(k_cache.dtype)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg,
                          k_cache).float() * (1.0 / np.sqrt(d))
    mask = (key_pos >= 0) & (key_pos <= qpos[:, None])
    if sliding_window is not None:
        mask &= key_pos > qpos[:, None] - sliding_window
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    # probs in the cache's dtype: the AV product reads the cache as stored
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v_cache)
    return out.reshape(b, 1, h, d).to(q.dtype)


def cache_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
                key_pos: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                pos: torch.Tensor):
    """Write one token's K/V into the ring cache at slot = pos % W.

    k_cache/v_cache: [B, W, Hkv, D]; key_pos: [B, W]; k/v: [B, 1, Hkv, D];
    pos: [B].  Unlike the JAX package, which returns new arrays, the port
    writes the three tensors in place (they may be views into a cache
    stacked on layers) and returns them."""
    b, w = k_cache.shape[:2]
    slot = pos.long() % w
    bidx = torch.arange(b, device=k_cache.device)
    k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)
    key_pos[bidx, slot] = pos.to(key_pos.dtype)
    return k_cache, v_cache, key_pos


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
              cache: Optional[Tuple] = None,
              sliding_window: Optional[int] = None):
    """Pre-norm GQA attention block.  Returns (out, new_cache).

    Train/prefill: cache=None, a full sequence at positions [B|1, S].
    Decode: x is [B, 1, d]; cache = (k_cache, v_cache, key_pos) in the
    ring layout of `decode_attention`, written in place by `cache_write`;
    positions [B] are the absolute positions of the tokens written.
    """
    y = rms_norm(x, params["ln"], cfg.norm_eps)
    if cache is None:
        q, k, v = qkv(params, y, cfg, positions)
        attn = attention(q, k, v, causal=True, sliding_window=sliding_window,
                         impl=cfg.attn_impl)
        return attn_out(params, attn, cfg), None
    q, k, v = qkv(params, y, cfg, positions[:, None])
    k_cache, v_cache, key_pos = cache_write(*cache, k, v, positions)
    dt = to_dtype(cfg.compute_dtype)
    attn = decode_attention(q, cast(k_cache, dt), cast(v_cache, dt),
                            key_pos, positions,
                            sliding_window=sliding_window)
    return attn_out(params, attn, cfg), (k_cache, v_cache, key_pos)


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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token loss over every position, as in the JAX package: an
    fp32 logsumexp over the whole (padded) vocab, no label mask."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None]).squeeze(-1)
    return (logz - gold).mean()
