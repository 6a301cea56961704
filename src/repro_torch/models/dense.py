"""Dense GQA transformer (qwen2 / smollm) in plain PyTorch.

Sequential pre-norm blocks.  The JAX package's `lax.scan` over the stacked
layer axis is a Python loop here.  Decode runs one token against the ring
KV cache of `cache_spec`, written in place.  Parallel blocks (command-r)
and the VLM patch embeddings come with their own slices.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import layers as L
from .common import P, attn_cache_spec, decode_window, padded_vocab, stacked


def layer_schema(cfg) -> Dict[str, P]:
    d, hd = cfg.d_model, cfg.head_dim_
    s: Dict[str, P] = {
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
    if cfg.qkv_bias:
        s["wq_b"] = P((cfg.n_heads * hd,), ("heads",), init="zeros")
        s["wk_b"] = P((cfg.n_kv_heads * hd,), ("kv_heads",), init="zeros")
        s["wv_b"] = P((cfg.n_kv_heads * hd,), ("kv_heads",), init="zeros")
    return s


def schema(cfg) -> Dict[str, Any]:
    check_supported(cfg)
    v = padded_vocab(cfg)
    s: Dict[str, Any] = {
        "embedding": P((v, cfg.d_model), ("vocab", "embed")),
        "ln_f": P((cfg.d_model,), ("act_embed",), init="ones"),
        "layers": stacked(cfg.n_layers, layer_schema(cfg)),
    }
    if not cfg.tie_embeddings:
        s["unembedding"] = P((v, cfg.d_model), ("vocab", "embed"))
    return s


def check_supported(cfg) -> None:
    if cfg.parallel_block:
        raise ValueError(f"{cfg.name}: parallel blocks are not ported yet "
                         "(they come with the command-r slice)")


def _block(params, x, cfg, *, positions, cache=None, sliding_window=None):
    """One sequential pre-norm transformer block; returns (x, new_cache)."""
    attn, new_cache = L.gqa_block(params, x, cfg, positions=positions,
                                  cache=cache, sliding_window=sliding_window)
    x = x + attn
    return x + L.swiglu({**params, "ln": params["ln2"]}, x, cfg), new_cache


def _embed_inputs(params, batch, cfg):
    """Token embeddings and their positions (text only)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    return L.embed(params, tokens, cfg), positions


def layer(params, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s parameters: views into the stacked tree."""
    return {k: v[i] for k, v in params["layers"].items()}


def forward(params, batch, cfg) -> torch.Tensor:
    check_supported(cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    for i in range(cfg.n_layers):
        x, _ = _block(layer(params, i), x, cfg, positions=positions,
                      sliding_window=cfg.sliding_window)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.unembed(params, x, cfg)


# ------------------------------------------------------------------ decode
def cache_spec(cfg, batch: int, max_len: int) -> Dict[str, P]:
    return attn_cache_spec(cfg, batch, decode_window(cfg, max_len))


def decode_step(params, cache, batch, cfg):
    """One token: batch = {"tokens": [B, 1], "pos": [B]}.  Returns (logits
    [B, 1, V], cache); the cache's tensors are updated in place."""
    check_supported(cfg)
    x = L.embed(params, batch["tokens"], cfg)
    pos = batch["pos"]
    for i in range(cfg.n_layers):
        x, _ = _block(layer(params, i), x, cfg, positions=pos,
                      cache=(cache["k"][i], cache["v"][i],
                             cache["key_pos"][i]),
                      sliding_window=cfg.sliding_window)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.unembed(params, x, cfg), cache
