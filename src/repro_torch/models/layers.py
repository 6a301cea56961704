"""Shared building blocks of the port's models (plain PyTorch): norms,
RoPE, attention (full-sequence and against the ring KV cache), MLP,
embeddings and the training loss.

Functional, as in the JAX package: params are nested dicts of tensors and
these functions only compute.  ``rules`` is an optional logical-axis table
(`repro_torch.parallel.sharding`): with rules, DTensor activations are
redistributed at the JAX package's sharding-constraint sites; without,
those sites are the identity.  Layouts follow the JAX package: activations
[B, S, d], heads [B, S, H, D].
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import trace
from ..parallel.sharding import logical_constraint as lc
from ..parallel.sharding import (map_shards, placements, redistribute,
                                 shard_dims, spec_for, weight_for)
from .common import to_dtype

NEG_INF = -1e30


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if x.dtype == dtype else x.to(dtype)


def linear(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype):
    """``x @ w`` with ``w`` cast to ``dtype`` and, on a mesh, placed for
    ``x`` by `weight_for`.  Where that leaves the weight whole on every
    rank (sequence parallelism), each rank multiplies its own rows as
    plain tensors: through DTensor the product would flatten a batch and a
    sequence sharded on two mesh dims into one, which some torch versions
    cannot place."""
    w = weight_for(x, cast(w, dtype))
    if isinstance(w, DTensor) and shard_dims(x, 1) \
            and all(p == Replicate() for p in w.placements):
        return map_shards(torch.matmul, (x, w),
                          (x.placements, w.placements), (x.placements,))
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Normalised in fp32 with the population variance, cast to x's dtype,
    then scaled and shifted in that dtype, as the JAX package does."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(dt) * scale.to(dt) \
        + bias.to(dt)


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
def _without_seq(pl) -> list:
    """Placements ``pl`` with the sequence dim (1) replicated."""
    return [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in pl]


def place_attention(q: DTensor, k: torch.Tensor, v: torch.Tensor):
    """The einsum path's operands on a mesh, placed so that each rank
    computes its own share of the logits and nothing is replicated.

    q keeps its placements: its batch, and its query rows (sequence
    parallelism) or its heads (tensor parallelism).  K/V get the same
    batch and span the whole key sequence on every rank (gathered when
    sharded on it; [B, Skv, Hkv, D] is small beside the logits).  Where
    q's heads are sharded over more ranks than there are kv heads (8 kv
    heads on a 16-wide model axis), grouping the query heads over their kv
    head would split a sharded dim unevenly, which DTensor cannot place:
    K/V are then expanded to one head per query head and each rank keeps
    its own heads' (the JAX partitioner slices each rank's kv head out of
    the replicated K/V the same way)."""
    b, skv, hkv, d = k.shape
    h = q.shape[2]
    kv_pl = _without_seq(q.placements)
    if hkv % math.prod(q.device_mesh.size(i) for i in shard_dims(q, 2)):
        k, v = (redistribute(t, [Replicate() if isinstance(p, Shard)
                                 and p.dim in (1, 2) else p
                                 for p in t.placements])[:, :, :, None]
                .expand(b, skv, hkv, h // hkv, d).reshape(b, skv, h, d)
                for t in (k, v))
    return q, redistribute(k, kv_pl), redistribute(v, kv_pl)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sliding_window: Optional[int] = None,
              impl: str = "xla", rules=None) -> torch.Tensor:
    """Scaled-dot-product GQA attention.

    q: [B, Sq, H, D]; k/v: [B, Skv, Hkv, D].  ``impl`` selects the einsum
    path ("xla"), the flash kernel ("pallas": the CUDA kernel on a CUDA
    tensor, its plain version on a CPU one) or the kernel's plain version
    ("pallas_interpret"), for train/prefill shapes.  Unlike the JAX
    package's pallas path, the kernel paths keep ``sliding_window``.
    With ``rules`` and DTensor operands the einsum path places them by
    `place_attention`; the causal mask is built at global positions, so a
    rank holding a block of query rows masks them where they sit.
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

    if rules is None or not isinstance(q, DTensor):
        return _attend(q, k, v, torch.arange(q.shape[1], device=q.device),
                       causal, sliding_window)
    # on a mesh each rank attends its own query rows or heads as plain
    # tensors, the rows at their global positions
    q, k, v = place_attention(q, k, v)
    mesh = q.device_mesh
    rows = [Shard(0) if isinstance(p, Shard) and p.dim == 1 else Replicate()
            for p in q.placements]
    qpos = DTensor.from_local(torch.arange(q.shape[1], device=q.device),
                              mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
    return map_shards(
        functools.partial(_attend, causal=causal,
                          sliding_window=sliding_window),
        (q, k, v, qpos), (q.placements, k.placements, v.placements, rows),
        (q.placements,))


def _attend(q, k, v, qpos, causal, sliding_window):
    """The einsum path on plain tensors; qpos [Sq] are the query rows'
    positions in the key sequence."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    # grouped GQA: fold query heads over their kv head, no repeated K/V
    qg = q.reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * (1.0 / np.sqrt(d))
    qpos = qpos[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if sliding_window is not None:
        mask &= kpos > qpos - sliding_window
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h, v.shape[-1])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, key_pos: torch.Tensor,
                     qpos: torch.Tensor, *,
                     sliding_window: Optional[int] = None,
                     rules=None) -> torch.Tensor:
    """Single-token attention against a ring-buffer cache.

    q: [B, 1, H, D]; k_cache/v_cache: [B, W, Hkv, D]; key_pos: [B, W]
    (absolute position written to each slot, -1 = empty); qpos: [B].
    Keys are valid by position, not by slot order, so full caches (W =
    max_len) and sliding-window caches (W = window) are one code path.
    GQA is grouped: the cache is never repeated over query heads.  Both
    products read the cache in its storage dtype (an fp32 copy of the
    whole cache per call would cost more than the attention itself); the
    logits are taken to fp32 for the mask and the softmax.  With
    ``rules`` and a DTensor cache, each rank attends its own shards of the
    cache (`_decode_split_k`).
    """
    if rules is not None and isinstance(k_cache, DTensor):
        return lc(_decode_split_k(q, k_cache, v_cache, key_pos, qpos,
                                  sliding_window),
                  ("batch", None, "heads", None), rules)
    return _decode(q, k_cache, v_cache, key_pos, qpos, sliding_window)


def _decode_split_k(q, k_cache, v_cache, key_pos, qpos, sliding_window):
    """`decode_attention` on a mesh.  q follows the cache's batch and
    kv-head placements; where the window is sharded (split-K), a rank
    scores every query head against its own block of slots, and the
    softmax's max and sum and the weighted values are reduced over the
    ranks holding the other blocks."""
    mesh = k_cache.device_mesh
    q = redistribute(q, _without_seq(k_cache.placements))
    rows = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in q.placements]
    if not isinstance(qpos, DTensor):
        qpos = DTensor.from_local(qpos, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    groups = [mesh.get_group(i) for i in shard_dims(k_cache, 1)]
    return map_shards(
        functools.partial(_decode, sliding_window=sliding_window,
                          groups=groups),
        (q, k_cache, v_cache, key_pos, qpos),
        (q.placements, k_cache.placements, v_cache.placements,
         key_pos.placements, rows), (q.placements,))


def _decode(q, k_cache, v_cache, key_pos, qpos, sliding_window, groups=()):
    """`decode_attention` on plain tensors; with ``groups`` the cache is
    one block of the window, and the other blocks are on the ranks of
    those process groups."""
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).to(k_cache.dtype)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg,
                          k_cache).float() * (1.0 / np.sqrt(d))
    mask = (key_pos >= 0) & (key_pos <= qpos[:, None])
    if sliding_window is not None:
        mask &= key_pos > qpos[:, None] - sliding_window
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    if groups:
        m = _all_reduce(logits.amax(dim=-1, keepdim=True), "max", groups)
        e = torch.exp(logits - m)
        probs = e / _all_reduce(e.sum(dim=-1, keepdim=True), "sum", groups)
    else:
        probs = torch.softmax(logits, dim=-1)
    # probs in the cache's dtype: the AV product reads the cache as stored
    out = torch.einsum("bhgk,bkhd->bhgd", probs.to(v_cache.dtype), v_cache)
    if groups:
        out = _all_reduce(out.float(), "sum", groups)
    return out.reshape(b, 1, h, d).to(q.dtype)


def _all_reduce(x: torch.Tensor, op: str, groups) -> torch.Tensor:
    for g in groups:
        x = funcol.all_reduce(x, op, g)
    return x


def cache_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
                key_pos: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                pos: torch.Tensor):
    """Write one token's K/V into the ring cache at slot = pos % W.

    k_cache/v_cache: [B, W, Hkv, D]; key_pos: [B, W]; k/v: [B, 1, Hkv, D];
    pos: [B].  Unlike the JAX package, which returns new arrays, the port
    writes the three tensors in place (they may be views into a cache
    stacked on layers) and returns them."""
    slot = pos.long() % k_cache.shape[1]
    for cache, val in ((k_cache, k[:, 0]), (v_cache, v[:, 0]),
                       (key_pos, pos)):
        _ring_write(cache, slot, val)
    return k_cache, v_cache, key_pos


def _ring_write(cache: torch.Tensor, slot: torch.Tensor,
                val: torch.Tensor) -> None:
    """``cache[b, slot[b]] = val[b]`` for every row b, in place.  On a
    DTensor cache each rank writes the rows of its own batch shard whose
    slot falls in its own block of the window (split-K decode): DTensor
    has no strategy for this write that keeps the cache's placements."""
    if not isinstance(cache, DTensor):
        bidx = torch.arange(cache.shape[0], device=cache.device)
        cache[bidx, slot] = val.to(cache.dtype)
        return
    mesh, pl = cache.device_mesh, cache.placements

    def on(dim):
        return [Shard(0) if isinstance(p, Shard) and p.dim == dim
                else Replicate() for p in pl]
    val_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0
              else Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2
              else Replicate() for p in pl]
    rep = [Replicate()] * mesh.ndim
    wpos, slot, val = (t if isinstance(t, DTensor) else
                       DTensor.from_local(t, mesh, rep, run_check=False)
                       for t in (torch.arange(cache.shape[1],
                                              device=cache.device),
                                 slot, val))
    map_shards(_write_rows, (cache, slot, wpos, val),
               (pl, on(0), on(1), val_pl), ())


def _write_rows(cache, slot, wpos, val):
    """`_ring_write` on one rank's shards: wpos holds the window positions
    of the rank's block.  A row whose slot lies in another block writes
    back what it holds (shapes that do not depend on the data)."""
    b, w = cache.shape[:2]
    local = slot - wpos[0]
    inside = ((local >= 0) & (local < w)).view((b,) + (1,) * (val.ndim - 1))
    bidx, idx = torch.arange(b, device=cache.device), local.clamp(0, w - 1)
    cache[bidx, idx] = torch.where(inside, val.to(cache.dtype),
                                   cache[bidx, idx])


def qkv(params, y: torch.Tensor, cfg, positions: torch.Tensor, rules=None):
    """Projections of the normed input y [B, S, d] to rotated q
    [B, S, H, D], rotated k and v [B, S, Hkv, D]; positions [B|1, S]."""
    dt = to_dtype(cfg.compute_dtype)
    hd = cfg.head_dim_
    b, s, _ = y.shape

    def proj(name, heads, axis):
        # placed before the view: a projection DTensor leaves sharded on a
        # [H·D] it cannot split into heads would have to be gathered
        out = lc(linear(y, params[name], dt), ("batch", "seq", axis), rules)
        out = out.view(b, s, heads, hd)
        if cfg.qkv_bias and f"{name}_b" in params:
            out = out + cast(params[f"{name}_b"], dt).view(heads, hd)
        return out

    q = apply_rope(proj("wq", cfg.n_heads, "heads"), positions,
                   cfg.rope_theta)
    k = apply_rope(proj("wk", cfg.n_kv_heads, "kv_heads"), positions,
                   cfg.rope_theta)
    return q, k, proj("wv", cfg.n_kv_heads, "kv_heads")


def gathered(x: torch.Tensor, rules=None) -> torch.Tensor:
    """A projection [B, S, F] computed sharded on the model axis as an FFN
    activation is, then gathered whole on every rank, for a split or a
    view its shards do not line up with: each rank computes its slice of
    the product, and the gradient comes back sharded the same way, so the
    weight's gradient is a slice on each rank too (gathered at once,
    DTensor computes the whole product and its weight gradient on every
    rank)."""
    return lc(lc(x, ("batch", "seq", "act_mlp"), rules),
              ("batch", "seq", None), rules)


def attn_out(params, attn: torch.Tensor, cfg, rules=None) -> torch.Tensor:
    """Output projection of attention heads [B, S, H, D] → [B, S, d]."""
    # placed as the heads are, so that the gradient reaches the flatten in
    # a layout it can split back into heads
    flat = lc(attn.flatten(2), ("batch", "seq", "heads"), rules)
    out = linear(flat, params["wo"], to_dtype(cfg.compute_dtype))
    return lc(out, ("batch", "seq", "act_embed"), rules)


def gqa_block(params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              rules=None, cache: Optional[Tuple] = None,
              sliding_window: Optional[int] = None, norm: bool = True):
    """Pre-norm GQA attention block.  Returns (out, new_cache).

    Train/prefill: cache=None, a full sequence at positions [B|1, S].
    Decode: x is [B, 1, d]; cache = (k_cache, v_cache, key_pos) in the
    ring layout of `decode_attention`, written in place by `cache_write`;
    positions [B] are the absolute positions of the tokens written.
    ``norm=False`` skips the input norm (parallel blocks norm once).
    """
    y = rms_norm(x, params["ln"], cfg.norm_eps) if norm else x
    q, k, v = qkv(params, y, cfg,
                  positions if cache is None else positions[:, None], rules)
    q = lc(q, ("batch", "seq", "heads", None), rules)
    k = lc(k, ("batch", "seq", "kv_heads", None), rules)
    if cache is None:
        attn = attention(q, k, v, causal=True, sliding_window=sliding_window,
                         impl=cfg.attn_impl, rules=rules)
        return attn_out(params, attn, cfg, rules), None
    k_cache, v_cache, key_pos = cache_write(*cache, k, v, positions)
    dt = to_dtype(cfg.compute_dtype)
    attn = decode_attention(q, cast(k_cache, dt), cast(v_cache, dt),
                            key_pos, positions,
                            sliding_window=sliding_window, rules=rules)
    return attn_out(params, attn, cfg, rules), (k_cache, v_cache, key_pos)


def mla_block(params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              rules=None) -> torch.Tensor:
    """Pre-norm multi-head latent attention (DeepSeek-V2/V3, no query
    LoRA) over a full sequence at positions [B|1, S]; ``cfg.mla`` holds
    its sizes.  q = y·W_q as H heads of nope + rope dims; [c_kv | k_rope]
    = y·W_kva; c_kv normed with its own scale and lifted by W_kvb to
    [k_nope | v] per head; rotary (half-split) on each head's q_rope and on
    the one k_rope that every head shares.  Causal attention of Q, K over
    nope + rope dims (scale 1/sqrt of that) and V of ``v_dim``, then W_o.
    Under ``attn_impl`` "pallas" the flash kernel runs at those two head
    sizes.  No decode: a latent cache is not built."""
    dt = to_dtype(cfg.compute_dtype)
    a, h = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    y = rms_norm(x, params["ln"], cfg.norm_eps)
    q_nope, q_rope = linear(y, params["wq"], dt).view(
        b, s, h, a.qk_dim).split([a.qk_nope, a.qk_rope], dim=-1)
    c_kv, k_rope = linear(y, params["wkva"], dt).split(
        [a.kv_rank, a.qk_rope], dim=-1)
    c_kv = rms_norm(c_kv, params["kv_ln"], a.kv_norm_eps)
    k_nope, v = linear(c_kv, params["wkvb"], dt).view(
        b, s, h, a.qk_nope + a.v_dim).split([a.qk_nope, a.v_dim], dim=-1)
    k_rope = apply_rope(k_rope.view(b, s, 1, a.qk_rope), positions,
                        cfg.rope_theta)
    q = torch.cat([q_nope, apply_rope(q_rope, positions, cfg.rope_theta)],
                  dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, a.qk_rope)], dim=-1)
    attn = attention(q, k, v, causal=True, impl=cfg.attn_impl, rules=rules)
    return attn_out(params, attn, cfg, rules)


# ------------------------------------------------------------------- MLPs
def swiglu(params, x: torch.Tensor, cfg, rules=None,
           pre_normed: bool = False) -> torch.Tensor:
    dt = to_dtype(cfg.compute_dtype)
    y = x if pre_normed else rms_norm(x, params["ln"], cfg.norm_eps)
    h = F.silu(linear(y, params["w_gate"], dt)) \
        * linear(y, params["w_up"], dt)
    h = lc(h, ("batch", "seq", "act_mlp"), rules)
    return lc(linear(h, params["w_down"], dt), ("batch", "seq", "act_embed"),
              rules)


def gelu_mlp(params, x: torch.Tensor, cfg, rules=None) -> torch.Tensor:
    """LayerNorm, up-projection with bias, GELU in its tanh form (the
    default of `jax.nn.gelu`), down-projection with bias."""
    dt = to_dtype(cfg.compute_dtype)
    y = layer_norm(x, params["ln"], params["ln_b"], cfg.norm_eps)
    h = F.gelu(linear(y, params["w_up"], dt) + cast(params["b_up"], dt),
               approximate="tanh")
    h = lc(h, ("batch", "seq", "act_mlp"), rules)
    # reduced here, as `swiglu`'s output is: left a partial sum, it would
    # run on through the residual and the next norm into a product that
    # DTensor then computes whole on every rank
    return lc(linear(h, params["w_down"], dt), ("batch", "seq", "act_embed"),
              rules) + cast(params["b_down"], dt)


# -------------------------------------------------------------------- MoE
def moe_route(router: torch.Tensor, flat: torch.Tensor, m,
              bias: Optional[torch.Tensor] = None, rows: int = 1):
    """Router of a top-k MoE layer, in fp32.  flat: [T, d], ``rows``
    sequences of T / rows tokens each.  Returns (probs [T, experts],
    top_p [T, k], top_e [T, k], aux).

    ``m.scoring`` "softmax" (olmoe, granite): softmax over the real
    experts, the top k renormalised, the Switch load-balancing loss.
    "sigmoid" (DeepSeek-V3): scores s = sigmoid of the logits, the top k
    chosen by s + ``bias`` (the correction bias, which only selects),
    weighted by their s over its sum × ``m.routed_scale``, and the
    sequence-wise balance loss (`seq_balance_loss`); probs are s."""
    if m.scoring == "sigmoid":
        scores = torch.sigmoid(flat.float() @ router.float())
        top_e = torch.topk(scores + bias.float(), m.top_k, dim=-1).indices
        top_p = scores.gather(-1, top_e)
        top_p = top_p / (top_p.sum(dim=-1, keepdim=True) + 1e-20) \
            * m.routed_scale
        return scores, top_p, top_e, seq_balance_loss(scores, top_e, m,
                                                      rows)
    probs = torch.softmax(flat.float() @ router.float(), dim=-1)
    top_p, top_e = torch.topk(probs, m.top_k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    ce = F.one_hot(top_e[:, 0], m.num_experts).float().mean(dim=0)
    aux = m.num_experts * (probs.mean(dim=0) * ce).sum() \
        * m.router_aux_weight
    return probs, top_p, top_e, aux


def seq_balance_loss(scores: torch.Tensor, top_e: torch.Tensor, m,
                     rows: int) -> torch.Tensor:
    """DeepSeek-V3's sequence-wise balance loss: for each of the ``rows``
    sequences of S tokens, f_i = E / (k·S) × the choices of expert i and
    P_i = the mean over its tokens of s_i / Σ_j s_j; α Σ_i f_i P_i
    (α = ``m.router_aux_weight``), averaged over the sequences.
    scores [T, E], top_e [T, k]."""
    t, e = scores.shape
    s = t // rows
    counts = torch.zeros((rows, e), dtype=torch.float32,
                         device=scores.device).scatter_add_(
        1, top_e.reshape(rows, s * m.top_k),
        torch.ones((rows, s * m.top_k), dtype=torch.float32,
                   device=scores.device))
    f = counts * (e / (m.top_k * s))
    p = (scores / scores.sum(dim=-1, keepdim=True)).view(rows, s, e).mean(1)
    return m.router_aux_weight * (f * p).sum(dim=-1).mean()


def moe_capacity(n_tok: int, m) -> int:
    """Slots per expert: ceil(tokens · k / experts · capacity_factor),
    in Python, as the JAX package computes it."""
    return max(int(np.ceil(n_tok * m.top_k / m.num_experts
                           * m.capacity_factor)), 1)


def moe_slots(top_e: torch.Tensor, e_pad: int) -> torch.Tensor:
    """Slot of each (token, choice) within its expert, in token-major
    order (0-based): a running count of a one-hot over the padded
    experts.  The one-hot is laid out [experts, T·k] so that the count
    runs along the inner dim: down the outer dim of a [T·k, experts]
    one-hot a cumsum is one serial pass per expert (~50 ms a layer at
    olmoe's 4 × 4096 prefill on an H100).  top_e: [T, k] → [T·k]."""
    flat_e = top_e.reshape(-1)
    onehot = torch.arange(e_pad, device=top_e.device)[:, None] == flat_e
    return onehot.cumsum(dim=1).gather(0, flat_e[None])[0] - 1


# While a list, every `moe_block` call appends what it routed: "probs"
# [T, experts] (detached), "top_e" [T, k] and "keep" [T·k] (the choices
# that got a slot), as tensors on their device with no sync.  For
# observing routing from outside (drop shares, agreement between two
# runs); None, the default, records nothing.
ROUTE_LOG = None


def moe_block(params, x: torch.Tensor, cfg, rules=None):
    """Top-k expert routing with a fixed capacity per expert (gather and
    scatter dispatch), as the JAX package's `moe_block`.  Returns (out,
    aux).  Choices past an expert's capacity are dropped: they go to an
    overflow row of the dispatch buffer, which is cut off, and get no
    weight in the combine.  The expert products are batched over the
    padded experts, whose weights no choice reaches.

    DeepSeek-V3's layer (`DeepSeekMoEConfig`): sigmoid routing with the
    correction bias ``params["router_bias"]`` (`moe_route`), shared
    experts (``shared_gate``, ``shared_up``, ``shared_down``) on every
    token, and a held share: the weights are those of experts
    [``held_first``, ``held_first + held``) of the router's, and only
    choices routed to them are dispatched, computed and combined (the
    mechanism of a mesh's expert split, with one rank's ids).  Capacity
    and slots are counted over all the router's experts, so the shares of
    a layer add up to the whole.  While tracing, spans ``moe.route``
    (counts ``choices``, and as tensors on the card ``held_choices`` and
    ``dropped_choices``: held but past capacity), ``moe.dispatch``,
    ``moe.experts``, ``moe.combine``, ``moe.shared`` time the parts.

    On a mesh the capacity, slots and drops are those of the call's
    global tokens, as in JAX; the flattened tokens and the output keep
    the batch's placements (their gradients too), and the dispatch, the
    expert products and the combine run per shard (`_dispatch`,
    `_expert_ffn`, `_combine`): DTensor's strategies for these gathers,
    scatters and batched products differ between torch versions, and
    fail in some or compute whole on every rank in others.

    The expert products on a mesh.  The dispatch buffer is held at
    ("experts", None, "act_embed"), as in JAX: its experts split over the
    model axis, its capacity and d whole on every other mesh dim; the
    weights [experts, d, mlp] / [experts, mlp, d] are split the same way
    over their experts and over "data" on d (FSDP).  Each rank takes its
    slice of the capacity over every mesh dim that does not split the
    experts (a slice of a replicated buffer: no communication) and the
    whole d of its experts' weights (gathered over "data"), so the
    products contract nothing that is split: each rank computes its
    experts × its capacity slice, an even share, and no output is a
    partial sum.  The result is gathered back over the capacity.  In
    backward the weights' gradients are partial sums over the capacity
    slices, reduced onto their FSDP shards, and the buffer's gradient is
    gathered over them.  The capacity need not divide evenly (a decode
    step's few slots over 16 ranks)."""
    m = cfg.moe
    dt = to_dtype(cfg.compute_dtype)
    y = rms_norm(x, params["ln"], cfg.norm_eps)
    b, s, d = y.shape
    n_tok = b * s
    # flattened from the batch's placements alone: some torch versions
    # cannot place the view of a sequence sharded under sequence
    # parallelism.  The flattened tokens are held there too: the router's
    # backward would otherwise hand their gradient back split over the
    # model axis as well, which the view back to [B, S, d] cannot place
    # when a batch shard holds fewer rows than that axis has ranks
    y = lc(y, ("batch", None, "act_embed"), rules)
    flat = lc(y.reshape(n_tok, d), ("batch", "act_embed"), rules)
    with trace.span("moe.route", device=True,
                    choices=n_tok * m.top_k) as sp:
        probs, top_p, top_e, aux = moe_route(
            params["router"], flat, m, params.get("router_bias"), rows=b)
        capacity = moe_capacity(n_tok, m)
        flat_e = top_e.reshape(-1)                        # [T·k]
        slot = moe_slots(top_e, m.e_pad)
        keep = slot < capacity
        if sp is not trace.OFF:
            held = (flat_e >= m.held_first) \
                & (flat_e < m.held_first + m.n_held)
            sp["held_choices"] = held.sum()
            sp["dropped_choices"] = (held & ~keep).sum()
    if ROUTE_LOG is not None:
        ROUTE_LOG.append({"probs": probs.detach(), "top_e": top_e,
                          "keep": keep})
    e_idx = torch.where(keep, flat_e, m.e_pad)            # overflow row
    s_idx = torch.where(keep, slot, 0)
    experts, tok, exp, by_tok, by_exp = _moe_shards(flat, m, rules)
    with trace.span("moe.dispatch", device=True):
        expert_in = _unstack(map_shards(
            functools.partial(_dispatch, k=m.top_k, capacity=capacity,
                              dt=dt),
            (flat, e_idx, s_idx, experts), (tok, tok, tok, exp),
            (by_tok,)))
        expert_in = lc(expert_in, ("experts", None, "act_embed"), rules)
    ffn_pl, w_pl = _ffn_shards(expert_in)
    with trace.span("moe.experts", device=True):
        expert_out = lc(map_shards(
            _expert_ffn, (expert_in, *(cast(params[n], dt) for n in
                                       ("w_gate", "w_up", "w_down"))),
            (ffn_pl, w_pl, w_pl, w_pl), (ffn_pl,), (expert_in.shape,)),
            ("experts", None, "act_embed"), rules)
    with trace.span("moe.combine", device=True):
        out = _unstack(map_shards(
            functools.partial(_combine, k=m.top_k, dt=dt),
            (expert_out, e_idx, s_idx, top_p.reshape(-1), experts),
            (exp, tok, tok, tok, exp), (by_exp,)))
        out = lc(out, ("batch", "act_embed"), rules).reshape(b, s, d)
    if m.d_shared:
        with trace.span("moe.shared", device=True):
            out = out + swiglu({"w_gate": params["shared_gate"],
                                "w_up": params["shared_up"],
                                "w_down": params["shared_down"]}, y, cfg,
                               rules=rules, pre_normed=True)
    return out, aux


def _moe_shards(flat, m, rules):
    """The ids of the experts held (all ``m.e_pad``, or ``m``'s held
    share) and the placements of `_dispatch` and `_combine`: the tokens
    and their choices split as the batch, the ids as the experts, and the
    output of each stacked on a new leading dim over the mesh dims that
    split what it sums (the tokens for the dispatch, the experts for the
    combine).  Without a mesh, plain ids and no placements; a mesh splits
    every expert, not a share."""
    experts = torch.arange(m.held_first, m.held_first + m.n_held,
                           device=flat.device)
    if rules is None or not isinstance(flat, DTensor):
        return experts, None, None, None, None
    if m.n_held != m.e_pad:
        raise NotImplementedError("moe_block: a held share of the experts "
                                  "on a mesh")
    mesh = flat.device_mesh
    experts = DTensor.from_local(experts, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    tok = placements(spec_for(("batch",), rules), mesh)
    exp = placements(spec_for(("experts",), rules), mesh)

    def stacked(first, second):
        return [Shard(0) if a != Replicate() else
                Shard(1) if b != Replicate() else Replicate()
                for a, b in zip(first, second)]
    return experts, tok, exp, stacked(tok, exp), stacked(exp, tok)


def _ffn_shards(expert_in):
    """The placements of `_expert_ffn`'s buffer (and output) and of its
    weights: the experts split as ``expert_in``'s, the capacity over
    every other mesh dim, the weights whole but for their experts.  None
    without a mesh."""
    if not isinstance(expert_in, DTensor):
        return None, None
    experts = [p == Shard(0) for p in expert_in.placements]
    return ([Shard(0) if e else Shard(1) for e in experts],
            [Shard(0) if e else Replicate() for e in experts])


def _expert_ffn(x, w_gate, w_up, w_down):
    """The experts' SwiGLU, batched over the experts: x [experts, slots,
    d] → [experts, slots, d]."""
    return torch.bmm(F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_up),
                     w_down)


def _unstack(x: torch.Tensor) -> torch.Tensor:
    """The blocks of `_dispatch` or `_combine` summed over their stacked
    dim (one block, a view, without a mesh)."""
    return x.sum(dim=0) if isinstance(x, DTensor) else x[0]


def _local(e_idx, experts):
    """Which choices go to the experts held here, and their rows."""
    inside = (e_idx >= experts[0]) & (e_idx <= experts[-1])
    return inside, e_idx - experts[0]


def _dispatch(flat, e_idx, s_idx, experts, *, k, capacity, dt):
    """`moe_block`'s dispatch on one rank: the kept choices of its tokens
    (flat [T, d]; e_idx, s_idx [T·k], e_idx past the experts for a drop)
    that go to the experts it holds (``experts``: their ids) written into
    their slots.  Returns [1, experts, capacity, d]: on a mesh, one block
    per rank that splits the tokens, summed by the caller."""
    inside, row = _local(e_idx, experts)
    n = experts.shape[0]
    tok_idx = torch.arange(e_idx.shape[0], device=flat.device) // k
    buf = torch.zeros((n + 1, capacity, flat.shape[1]), dtype=dt,
                      device=flat.device)
    return buf.index_put((torch.where(inside, row, n),
                          torch.where(inside, s_idx, 0)),
                         cast(flat[tok_idx], dt))[:-1][None]


def _combine(expert_out, e_idx, s_idx, weight, experts, *, k, dt):
    """`moe_block`'s combine on one rank: its tokens' kept choices that
    the experts it holds computed (expert_out [experts, capacity, d]),
    weighted by the renormalised router probabilities (weight [T·k]) and
    summed per token.  Returns [1, T, d]: on a mesh, one block per rank
    that splits the experts, summed by the caller."""
    inside, row = _local(e_idx, experts)
    # one flat index per choice, gathered by `index_select`, whose
    # backward adds each choice's gradient into its slot with atomics.
    # Indexing by (row, slot) pairs would sort the choices in backward and
    # sum each slot's serially, and every choice outside the experts held
    # (dropped, or another rank's: weight 0) lands on a slot of row 0,
    # thousands to a slot under a held share
    n, capacity, d = expert_out.shape
    gathered = expert_out.reshape(n * capacity, d).index_select(
        0, torch.where(inside, row, 0) * capacity + s_idx)      # [T·k, d]
    weight = torch.where(inside, weight, 0.0).to(dt)
    tok_idx = torch.arange(e_idx.shape[0], device=e_idx.device) // k
    return torch.zeros((e_idx.shape[0] // k, expert_out.shape[-1]),
                       dtype=dt, device=e_idx.device).index_add(
        0, tok_idx, gathered * weight[:, None])[None]


# -------------------------------------------------------------- embeddings
def embed(params, tokens: torch.Tensor, cfg, rules=None) -> torch.Tensor:
    table = params["embedding"]
    # gather, then cast: the same values as casting the table first
    x = _embed_shards(table, tokens) if isinstance(table, DTensor) \
        else table[tokens]
    return lc(cast(x, to_dtype(cfg.compute_dtype)),
              ("batch", "seq", "act_embed"), rules)


def _embed_shards(table: DTensor, tokens: torch.Tensor) -> DTensor:
    """The lookup on a mesh: each rank looks its tokens up in its own
    block of the vocab (zero rows for the others' tokens) and the blocks
    are summed; the table is gathered where its embed dim is sharded
    (FSDP).  DTensor's own strategies for the lookup and its backward
    fail at these placements in some torch versions."""
    mesh = table.device_mesh
    vocab = shard_dims(table, 0)
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tok_pl = [Replicate() if i in vocab else p
              for i, p in enumerate(tokens.placements)]
    tab_pl = [Shard(0) if i in vocab else Replicate()
              for i in range(mesh.ndim)]
    rows = DTensor.from_local(torch.arange(table.shape[0],
                                           device=table.device),
                              mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
    # one block per rank on a new leading dim, summed over it by DTensor
    out_pl = [Shard(0) if i in vocab else
              Shard(p.dim + 1) if isinstance(p, Shard) else p
              for i, p in enumerate(tok_pl)]
    return map_shards(_lookup, (table, tokens, rows),
                      (tab_pl, tok_pl, tab_pl), (out_pl,)).sum(dim=0)


def _lookup(table, tokens, rows):
    """`_embed_shards` on one rank: rows holds the vocab ids of its block;
    returns [1, *tokens.shape, d]."""
    local = tokens.long() - rows[0]
    inside = ((local >= 0) & (local < table.shape[0]))[..., None]
    x = table[local.clamp(0, table.shape[0] - 1)]
    return torch.where(inside, x, torch.zeros_like(x))[None]


def unembed(params, x: torch.Tensor, cfg, rules=None) -> torch.Tensor:
    w = params.get("unembedding", params["embedding"])
    return lc(linear(x, w.T, to_dtype(cfg.compute_dtype)),
              ("batch", "seq", "act_vocab"), rules)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token loss over every position, as in the JAX package: an
    fp32 logsumexp over the whole (padded) vocab, no label mask."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])
    if isinstance(gold, DTensor):
        # gathered from a sharded vocab it is a masked partial sum: reduced
        # before the squeeze, whose output DTensor's mask no longer fits
        gold = redistribute(gold, [Replicate() if p.is_partial() else p
                                   for p in gold.placements])
    return (logz - gold.squeeze(-1)).mean()
