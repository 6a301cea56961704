"""Whisper-style encoder-decoder (whisper-medium) in PyTorch.

The conv frontend is a stub, as in the JAX package: the batch carries
precomputed frame embeddings [B, encoder_seq, d_model].  LayerNorm blocks
with biases, GELU MLPs, learned decoder positions, sinusoidal encoder
positions, tied decoder embedding and unembedding.  The encoder's
self-attention is non-causal over Sq = Skv = encoder_seq, so under
``attn_impl="pallas"`` it runs the flash kernel's non-causal branch; the
decoder's causal self-attention in `forward` runs it causal.  The
decoder's cross-attention (Sq ≠ Skv) stays on the einsum path.

Decode keeps the decoder's self-attention ring cache and the
cross-attention K/V, made once from the encoder output (`make_cross_kv`)
and stored in the cache.  The JAX package's `lax.scan` over layers is a
Python loop here, under the config's remat policy.  Decode writes the
self-attention cache in place.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.sharding import logical_constraint as lc
from . import layers as L
from .common import (P, attn_cache_spec, decode_specs, decode_window,
                     layer_views, padded_vocab, remat, stacked, to_dtype,
                     token_specs)


# ------------------------------------------------------------------ schema
def _attn_schema(cfg, prefix: str) -> Dict[str, P]:
    d, hd = cfg.d_model, cfg.head_dim_
    return {
        f"{prefix}ln": P((d,), ("act_embed",), init="ones"),
        f"{prefix}ln_b": P((d,), ("act_embed",), init="zeros"),
        f"{prefix}wq": P((d, cfg.n_heads * hd), ("embed", "heads"),
                         init="scaled"),
        f"{prefix}wq_b": P((cfg.n_heads * hd,), ("heads",), init="zeros"),
        f"{prefix}wk": P((d, cfg.n_kv_heads * hd), ("embed", "kv_heads"),
                         init="scaled"),
        f"{prefix}wv": P((d, cfg.n_kv_heads * hd), ("embed", "kv_heads"),
                         init="scaled"),
        f"{prefix}wv_b": P((cfg.n_kv_heads * hd,), ("kv_heads",),
                           init="zeros"),
        f"{prefix}wo": P((cfg.n_heads * hd, d), ("heads", "embed"),
                         init="scaled"),
        f"{prefix}wo_b": P((d,), ("act_embed",), init="zeros"),
    }


def _mlp_schema(cfg) -> Dict[str, P]:
    d = cfg.d_model
    return {
        "mlp_ln": P((d,), ("act_embed",), init="ones"),
        "mlp_ln_b": P((d,), ("act_embed",), init="zeros"),
        "w_up": P((d, cfg.d_ff), ("embed", "mlp"), init="scaled"),
        "b_up": P((cfg.d_ff,), ("mlp",), init="zeros"),
        "w_down": P((cfg.d_ff, d), ("mlp", "embed"), init="scaled"),
        "b_down": P((d,), ("act_embed",), init="zeros"),
    }


def enc_layer_schema(cfg) -> Dict[str, P]:
    return {**_attn_schema(cfg, "self_"), **_mlp_schema(cfg)}


def dec_layer_schema(cfg) -> Dict[str, P]:
    return {**_attn_schema(cfg, "self_"), **_attn_schema(cfg, "cross_"),
            **_mlp_schema(cfg)}


def schema(cfg) -> Dict[str, Any]:
    v = padded_vocab(cfg)
    e = cfg.encdec
    return {
        "embedding": P((v, cfg.d_model), ("vocab", "embed")),
        "pos_emb": P((cfg.max_seq, cfg.d_model), (None, "embed")),
        "enc_ln_f": P((cfg.d_model,), ("act_embed",), init="ones"),
        "enc_ln_f_b": P((cfg.d_model,), ("act_embed",), init="zeros"),
        "dec_ln_f": P((cfg.d_model,), ("act_embed",), init="ones"),
        "dec_ln_f_b": P((cfg.d_model,), ("act_embed",), init="zeros"),
        "encoder": stacked(e.encoder_layers, enc_layer_schema(cfg)),
        "decoder": stacked(cfg.n_layers, dec_layer_schema(cfg)),
    }


# --------------------------------------------------------------- attention
def _proj(params, prefix, name, y, heads, hd, dt, rules=None,
          axis: str = "kv_heads") -> torch.Tensor:
    """y [B, S, d] → heads [B, S, heads, hd], a contiguous tensor (the
    flash kernel's TMA reads it as it is), plus the bias where the tree
    has one (``wk`` has none).  On a mesh the projection is placed on its
    logical ``axis`` before the view, as in `layers.qkv`."""
    b, s, _ = y.shape
    out = lc(L.linear(y, params[f"{prefix}{name}"], dt),
             ("batch", "seq", axis), rules).view(b, s, heads, hd)
    bkey = f"{prefix}{name}_b"
    if bkey in params:
        out = out + L.cast(params[bkey], dt).view(heads, hd)
    return out


def _attn(params, prefix, x, kv_src, cfg, *, causal, rules=None,
          cache: Optional[Tuple] = None, positions=None,
          static_kv: Optional[Tuple] = None):
    """LN attention block with biases, no RoPE.  Returns (out, cache').

    kv_src: where sequence K/V come from (the encoder output for
    cross-attention).  static_kv: precomputed (k, v), decode-time
    cross-attention.  cache: the (k, v, key_pos) ring views of one layer,
    decode-time self-attention, written in place.
    """
    dt = to_dtype(cfg.compute_dtype)
    hd = cfg.head_dim_
    y = L.layer_norm(x, params[f"{prefix}ln"], params[f"{prefix}ln_b"],
                     cfg.norm_eps)
    q = _proj(params, prefix, "wq", y, cfg.n_heads, hd, dt, rules, "heads")
    q = lc(q, ("batch", "seq", "heads", None), rules)

    new_cache = None
    if static_kv is not None:                    # decode cross-attn
        k, v = static_kv
        attn = L.attention(q, L.cast(k, dt), L.cast(v, dt), causal=False,
                           rules=rules)
    elif cache is not None:                      # decode self-attn
        # the JAX package norms kv_src again; in the decoder it is x, so
        # its keys come from y
        k = _proj(params, prefix, "wk", y, cfg.n_kv_heads, hd, dt, rules)
        v = _proj(params, prefix, "wv", y, cfg.n_kv_heads, hd, dt, rules)
        new_cache = L.cache_write(*cache, k, v, positions)
        k_c, v_c, key_pos = new_cache
        attn = L.decode_attention(q, L.cast(k_c, dt), L.cast(v_c, dt),
                                  key_pos, positions, rules=rules)
    else:                                        # full-sequence
        # self-attn keys come from the normed input; cross-attn keys come
        # from the (already final-normed) encoder output
        yk = y if kv_src is x else kv_src
        k = _proj(params, prefix, "wk", yk, cfg.n_kv_heads, hd, dt, rules)
        v = _proj(params, prefix, "wv", yk, cfg.n_kv_heads, hd, dt, rules)
        k = lc(k, ("batch", "seq", "kv_heads", None), rules)
        attn = L.attention(q, k, v, causal=causal, impl=cfg.attn_impl,
                           rules=rules)

    flat = lc(attn.flatten(2), ("batch", "seq", "heads"), rules)
    out = L.linear(flat, params[f"{prefix}wo"], dt) \
        + L.cast(params[f"{prefix}wo_b"], dt)
    return lc(out, ("batch", "seq", "act_embed"), rules), new_cache


def _mlp(params, x, cfg, rules=None):
    return L.gelu_mlp(
        {"ln": params["mlp_ln"], "ln_b": params["mlp_ln_b"],
         "w_up": params["w_up"], "b_up": params["b_up"],
         "w_down": params["w_down"], "b_down": params["b_down"]}, x, cfg,
        rules)


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's encoder positions, float64 (cast by the caller)."""
    t = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-t * np.arange(channels // 2))
    ang = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1)


@functools.lru_cache(maxsize=None)
def _device_sinusoids(length: int, channels: int, dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    # made once per dtype and device: a host-to-device copy per call would
    # stall the stream
    return torch.from_numpy(sinusoids(length, channels)).to(device=device,
                                                            dtype=dtype)


# --------------------------------------------------------------- enc / dec
def encode(params, frames, cfg, rules=None) -> torch.Tensor:
    """frames [B, encoder_seq, d] → the final-normed encoder output."""
    dt = to_dtype(cfg.compute_dtype)
    x = frames.to(dt) + _device_sinusoids(cfg.encdec.encoder_seq,
                                          cfg.d_model, dt, frames.device)
    x = lc(x, ("batch", "seq", "act_embed"), rules)

    def body(p, x):
        attn, _ = _attn(p, "self_", x, x, cfg, causal=False, rules=rules)
        x = x + attn
        return x + _mlp(p, x, cfg, rules)

    body = remat(body, cfg)
    for p in layer_views(params["encoder"]):
        x = body(p, x)
    return L.layer_norm(x, params["enc_ln_f"], params["enc_ln_f_b"],
                        cfg.norm_eps)


def _dec_layer(p, x, enc_out, cfg, *, rules=None, positions=None,
               cache=None, cross=None):
    """One decoder layer: causal self-attention (against ``cache`` in
    decode), cross-attention over ``enc_out`` or the precomputed
    ``cross`` (k, v), the MLP.  Returns (x, new self cache)."""
    attn, new_self = _attn(p, "self_", x, x, cfg, causal=True, rules=rules,
                           cache=cache, positions=positions)
    x = x + attn
    attn, _ = _attn(p, "cross_", x, enc_out, cfg, causal=False, rules=rules,
                    static_kv=cross)
    x = x + attn
    return x + _mlp(p, x, cfg, rules), new_self


def _final_norm(params, x, cfg):
    return L.layer_norm(x, params["dec_ln_f"], params["dec_ln_f_b"],
                        cfg.norm_eps)


def forward(params, batch, cfg, rules=None) -> torch.Tensor:
    """batch: {"frames": [B, encoder_seq, d], "tokens": [B, T]} → logits
    [B, T, V]."""
    enc_out = encode(params, batch["frames"], cfg, rules)
    tokens = batch["tokens"]
    dt = to_dtype(cfg.compute_dtype)
    x = L.embed(params, tokens, cfg, rules) \
        + L.cast(params["pos_emb"][:tokens.shape[1]], dt)[None]

    def body(p, x):
        return _dec_layer(p, x, enc_out, cfg, rules=rules)[0]

    body = remat(body, cfg)
    for p in layer_views(params["decoder"]):
        x = body(p, x)
    return L.unembed(params, _final_norm(params, x, cfg), cfg, rules)


# ------------------------------------------------------------------ decode
def cache_spec(cfg, batch: int, max_len: int) -> Dict[str, Any]:
    """The decoder's self-attention ring cache and the cross-attention
    K/V [L, B, encoder_seq, Hkv, D], both in the compute dtype."""
    e = cfg.encdec
    cross = (cfg.n_layers, batch, e.encoder_seq, cfg.n_kv_heads,
             cfg.head_dim_)
    axes = ("layers", "batch", "seq", "kv_heads", None)
    return {
        "self": attn_cache_spec(cfg, batch, decode_window(cfg, max_len)),
        "cross": {
            "k": P(cross, axes, init="zeros", dtype=cfg.compute_dtype),
            "v": P(cross, axes, init="zeros", dtype=cfg.compute_dtype),
        },
    }


def make_cross_kv(params, enc_out, cfg,
                  rules=None) -> Dict[str, torch.Tensor]:
    """The decoder's cross-attention K/V from the encoder output, stacked
    on layers (the prefill step of serving): {"k", "v"} [L, B,
    encoder_seq, Hkv, D]."""
    dt = to_dtype(cfg.compute_dtype)
    hd = cfg.head_dim_
    ks, vs = [], []
    for p in layer_views(params["decoder"]):
        ks.append(_proj(p, "cross_", "wk", enc_out, cfg.n_kv_heads, hd, dt,
                        rules))
        vs.append(_proj(p, "cross_", "wv", enc_out, cfg.n_kv_heads, hd, dt,
                        rules))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params, cache, batch, cfg, rules=None):
    """One token: batch = {"tokens": [B,1], "pos": [B]} against ``cache``
    (its "cross" from `make_cross_kv`).  Returns (logits [B,1,V], cache);
    the self-attention ring cache is updated in place."""
    tokens, pos = batch["tokens"], batch["pos"]
    dt = to_dtype(cfg.compute_dtype)
    # gather, then cast: the same values as casting the table first
    x = L.embed(params, tokens, cfg, rules) \
        + L.cast(params["pos_emb"][pos.long()], dt)[:, None]
    sc, cc = cache["self"], cache["cross"]
    for i, p in enumerate(layer_views(params["decoder"])):
        x, _ = _dec_layer(p, x, None, cfg, rules=rules, positions=pos,
                          cache=(sc["k"][i], sc["v"][i], sc["key_pos"][i]),
                          cross=(cc["k"][i], cc["v"][i]))
    return L.unembed(params, _final_norm(params, x, cfg), cfg,
                     rules), cache


def input_specs(cfg, shape) -> Dict[str, torch.Tensor]:
    """The step's inputs at ``shape`` as meta tensors."""
    if shape.kind == "decode":
        return decode_specs(shape.global_batch)
    specs = {"frames": torch.empty(
        (shape.global_batch, cfg.encdec.encoder_seq, cfg.d_model),
        dtype=to_dtype(cfg.compute_dtype), device="meta")}
    specs.update(token_specs(shape.global_batch, shape.seq_len))
    return specs
