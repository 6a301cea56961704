"""Mamba2 (SSD) blocks + Zamba2-style shared attention (zamba2-1.2b), in
PyTorch.

Prefill and training use the chunked SSD scan (`ssd_chunked`: the
hand-written CUDA kernel on a CUDA tensor, its plain version on a CPU one,
differentiable through its autograd Function); decode is the O(1)
recurrent update in plain PyTorch.  After every `hybrid.attn_period`
Mamba2 layers the weight-shared attention+MLP block is applied, with a
separate KV cache per application site.  The JAX package's `lax.scan` per
group is a Python loop here, under the config's remat policy (the shared
block is not rematerialised, as in the JAX package).  Decode writes its
caches in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

# the op has the contract of the JAX package's `mamba2.ssd_chunked`
# (xh [B,S,H,Pd], post-softplus dt, a_log, b/c [B,S,N], d_skip, chunk, s0)
from repro_torch.kernels.mamba2_scan import ssd_scan as ssd_chunked

from ..parallel.sharding import map_shards_by_axes
from ..parallel.sharding import logical_constraint as lc
from . import layers as L
from .common import (P, attn_cache_spec, decode_specs, decode_window,
                     layer_views, padded_vocab, remat, stacked, to_dtype,
                     token_specs)


# --------------------------------------------------------------- structure
def group_sizes(cfg) -> List[int]:
    """Mamba-layer run lengths; shared attention fires after each full
    `attn_period`-sized group (not after a trailing remainder)."""
    period = cfg.hybrid.attn_period if cfg.hybrid else cfg.n_layers
    sizes, left = [], cfg.n_layers
    while left > 0:
        sizes.append(min(period, left))
        left -= period
    return sizes


def num_attn_sites(cfg) -> int:
    period = cfg.hybrid.attn_period if cfg.hybrid else cfg.n_layers
    return sum(1 for s in group_sizes(cfg) if s == period) \
        if cfg.hybrid and cfg.hybrid.shared_attention else 0


def _dims(cfg):
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    nheads = inner // s.head_dim
    conv_dim = inner + 2 * s.state_dim
    return inner, nheads, conv_dim


# ------------------------------------------------------------------ schema
def layer_schema(cfg) -> Dict[str, P]:
    d, s = cfg.d_model, cfg.ssm
    inner, nheads, conv_dim = _dims(cfg)
    return {
        "ln": P((d,), ("act_embed",), init="ones"),
        # in_proj → [z(inner), x(inner), B(N), C(N), dt(H)]
        "in_proj": P((d, 2 * inner + 2 * s.state_dim + nheads),
                     ("embed", "heads"), init="scaled"),
        "conv_w": P((s.conv_width, conv_dim), ("conv", "heads"),
                    init="scaled", scale=0.5),
        "conv_b": P((conv_dim,), ("heads",), init="zeros"),
        "a_log": P((nheads,), ("heads",), init="ones"),
        "d_skip": P((nheads,), ("heads",), init="ones"),
        "dt_bias": P((nheads,), ("heads",), init="zeros"),
        "norm": P((inner,), ("heads",), init="ones"),
        "out_proj": P((inner, d), ("heads", "embed"), init="scaled"),
    }


def attn_block_schema(cfg) -> Dict[str, P]:
    """The single weight-shared attention + MLP block."""
    d, hd = cfg.d_model, cfg.head_dim_
    return {
        "ln": P((d,), ("act_embed",), init="ones"),
        "wq": P((d, cfg.n_heads * hd), ("embed", "heads"), init="scaled"),
        "wk": P((d, cfg.n_kv_heads * hd), ("embed", "kv_heads"),
                init="scaled"),
        "wv": P((d, cfg.n_kv_heads * hd), ("embed", "kv_heads"),
                init="scaled"),
        "wo": P((cfg.n_heads * hd, d), ("heads", "embed"), init="scaled"),
        "ln2": P((d,), ("act_embed",), init="ones"),
        "w_gate": P((d, cfg.d_ff), ("embed", "mlp"), init="scaled"),
        "w_up": P((d, cfg.d_ff), ("embed", "mlp"), init="scaled"),
        "w_down": P((cfg.d_ff, d), ("mlp", "embed"), init="scaled"),
    }


def schema(cfg) -> Dict[str, Any]:
    v = padded_vocab(cfg)
    s: Dict[str, Any] = {
        "embedding": P((v, cfg.d_model), ("vocab", "embed")),
        "ln_f": P((cfg.d_model,), ("act_embed",), init="ones"),
        "layers": stacked(cfg.n_layers, layer_schema(cfg)),
    }
    if cfg.hybrid and cfg.hybrid.shared_attention:
        s["shared_attn"] = attn_block_schema(cfg)
    return s


# --------------------------------------------------------------------- SSD
def ssd_step(s, xh, dt, a_log, b, c, d_skip):
    """Recurrent single-token SSD update.

    s: [B,H,Pd,N]; xh: [B,H,Pd]; dt: [B,H]; b,c: [B,N].
    Returns (y [B,H,Pd], s'), fp32."""
    dt = dt.float()
    decay = torch.exp(dt * -torch.exp(a_log.float()))     # [B,H]
    xf = xh.float()
    xw = xf * dt[..., None]                               # [B,H,Pd]
    s = s * decay[:, :, None, None] \
        + torch.einsum("bhp,bn->bhpn", xw, b.float())
    y = torch.einsum("bhpn,bn->bhp", s, c.float())
    return y + d_skip.float()[:, None] * xf, s


# ------------------------------------------------------------ Mamba2 block
def _split_proj(cfg, zxbcdt):
    inner, nheads, _ = _dims(cfg)
    n = cfg.ssm.state_dim
    return torch.split(zxbcdt, [inner, inner, n, n, nheads], dim=-1)


def mamba2_block(params, x_in, cfg, rules=None,
                 state: Optional[Tuple] = None):
    """Pre-norm Mamba2 block.  Returns (out, new_state).

    Prefill: state=None (zero initial state, discarded).
    Decode: x_in is [B,1,d]; state = (conv_buf [B,K-1,convdim], s
    [B,H,Pd,N]); new_state = (conv_buf', s'), new tensors.
    """
    dt_c = to_dtype(cfg.compute_dtype)
    s_cfg = cfg.ssm
    inner, nheads, _ = _dims(cfg)
    n = s_cfg.state_dim
    y = L.rms_norm(x_in, params["ln"], cfg.norm_eps)
    # the five pieces do not line up with the model axis' shards
    proj = L.gathered(L.linear(y, params["in_proj"], dt_c), rules)
    z, xs, b, c, dt_raw = _split_proj(cfg, proj)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())

    conv_in = torch.cat([xs, b, c], dim=-1)               # [B,S,convdim]
    w = params["conv_w"].float()                          # [K, convdim]
    k = s_cfg.conv_width
    new_state = None
    if state is None:
        # causal depthwise conv by shifted adds (the width is tiny, K=4)
        seq = conv_in.shape[1]
        seg = conv_in.float()
        acc = torch.zeros_like(seg)
        for i in range(k):
            shift = k - 1 - i
            if shift < seq:
                acc[:, shift:] += seg[:, :seq - shift] * w[i]
        conv_out = F.silu(acc + params["conv_b"].float())
        xs, b, c = torch.split(conv_out, [inner, n, n], dim=-1)
        xh = xs.reshape(*xs.shape[:2], nheads, s_cfg.head_dim)
        xh = lc(xh, ("batch", "seq", "heads", None), rules)
        # the scan runs on each rank's batch and heads, the whole sequence
        # in hand
        bsh, bs = ("batch", None, "heads"), ("batch", None, None)
        yh, _ = map_shards_by_axes(
            lambda *t: ssd_chunked(*t, chunk=s_cfg.chunk),
            (xh, dt, params["a_log"], b, c, params["d_skip"]),
            (bsh + (None,), bsh, ("heads",), bs, bs, ("heads",)),
            (bsh + (None,), ("batch", "heads", None, None)), rules)
    else:
        conv_buf, s0 = state
        hist = torch.cat([conv_buf, conv_in.to(conv_buf.dtype)], dim=1)
        conv_out = F.silu(torch.einsum("bkc,kc->bc", hist.float(), w)
                          + params["conv_b"].float())     # [B,convdim]
        xs1, b1, c1 = torch.split(conv_out, [inner, n, n], dim=-1)
        xh = xs1.reshape(-1, nheads, s_cfg.head_dim)
        yh, s_fin = ssd_step(s0, xh, dt[:, 0], params["a_log"], b1, c1,
                             params["d_skip"])
        yh = yh[:, None]                                  # [B,1,H,Pd]
        new_state = (hist[:, 1:], s_fin)

    yv = yh.reshape(*yh.shape[:2], inner)
    # gated RMSNorm (Mamba2: norm(y) ⊙ silu(z)), then out-projection
    yv = L.rms_norm(yv.to(dt_c), params["norm"], cfg.norm_eps) * F.silu(z)
    out = yv @ L.cast(params["out_proj"], dt_c)
    return lc(out, ("batch", "seq", "act_embed"), rules), new_state


def _shared_attn(params, x, cfg, *, positions, rules=None, cache=None):
    attn, new_cache = L.gqa_block(params, x, cfg, positions=positions,
                                  rules=rules, cache=cache,
                                  sliding_window=cfg.sliding_window)
    x = x + attn
    x = x + L.swiglu({**params, "ln": params["ln2"]}, x, cfg, rules=rules)
    return x, new_cache


def _layer(params, i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["layers"].items()}


# ----------------------------------------------------------------- forward
def forward(params, batch, cfg, rules=None) -> torch.Tensor:
    tokens = batch["tokens"]
    x = L.embed(params, tokens, cfg, rules)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    period = cfg.hybrid.attn_period if cfg.hybrid else cfg.n_layers

    def body(p, x):
        return x + mamba2_block(p, x, cfg, rules=rules)[0]

    body = remat(body, cfg)
    layers = layer_views(params["layers"])
    start = 0
    for size in group_sizes(cfg):
        for p in layers[start:start + size]:
            x = body(p, x)
        start += size
        if size == period and "shared_attn" in params:
            x, _ = _shared_attn(params["shared_attn"], x, cfg,
                                positions=positions, rules=rules)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.unembed(params, x, cfg, rules)


# ------------------------------------------------------------------ decode
def cache_spec(cfg, batch: int, max_len: int) -> Dict[str, Any]:
    s = cfg.ssm
    _, nheads, conv_dim = _dims(cfg)
    spec: Dict[str, Any] = {
        "conv": P((cfg.n_layers, batch, s.conv_width - 1, conv_dim),
                  ("layers", "batch", None, "heads"), init="zeros",
                  dtype=cfg.compute_dtype),
        "ssm": P((cfg.n_layers, batch, nheads, s.head_dim, s.state_dim),
                 ("layers", "batch", "heads", None, "state"),
                 init="zeros", dtype="float32"),
    }
    sites = num_attn_sites(cfg)
    if sites:
        spec["attn"] = attn_cache_spec(
            cfg, batch, decode_window(cfg, max_len), n_layers=sites)
    return spec


def decode_step(params, cache, batch, cfg, rules=None):
    """One token: batch = {"tokens": [B,1], "pos": [B]}.  Returns (logits
    [B,1,V], cache); the conv, SSM and ring KV caches are updated in
    place."""
    x = L.embed(params, batch["tokens"], cfg, rules)
    pos = batch["pos"]
    period = cfg.hybrid.attn_period if cfg.hybrid else cfg.n_layers
    start, site = 0, 0
    for size in group_sizes(cfg):
        for i in range(start, start + size):
            out, (conv, ssm) = mamba2_block(
                _layer(params, i), x, cfg, rules=rules,
                state=(cache["conv"][i], cache["ssm"][i]))
            cache["conv"][i].copy_(conv)
            cache["ssm"][i].copy_(ssm)
            x = x + out
        start += size
        if size == period and "shared_attn" in params:
            ac = cache["attn"]
            x, _ = _shared_attn(
                params["shared_attn"], x, cfg, positions=pos, rules=rules,
                cache=(ac["k"][site], ac["v"][site], ac["key_pos"][site]))
            site += 1
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.unembed(params, x, cfg, rules), cache


def input_specs(cfg, shape) -> Dict[str, torch.Tensor]:
    """The step's inputs at ``shape`` as meta tensors."""
    if shape.kind == "decode":
        return decode_specs(shape.global_batch)
    return token_specs(shape.global_batch, shape.seq_len)
