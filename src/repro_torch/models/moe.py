"""Mixture-of-Experts transformer (olmoe-1b-7b, granite-moe-3b-a800m) in
plain PyTorch.

Every layer: GQA attention, then a top-k routed expert SwiGLU FFN with a
fixed capacity per expert (`layers.moe_block`: dense dispatch into an
[experts, capacity, d] buffer, batched expert products).  The router's
auxiliary loss is summed over the layers and returned to the loss by
``forward(..., return_aux=True)``.  Expert leaves are [L, e_pad, ...]:
padded experts (granite) are in the tree but no token reaches them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import layers as L
from .common import (P, attn_cache_spec, decode_window, layer_views,
                     padded_vocab, remat, stacked)
from .dense import input_specs, layer  # noqa: F401


def layer_schema(cfg) -> Dict[str, P]:
    d, hd, m = cfg.d_model, cfg.head_dim_, cfg.moe
    return {
        "ln": P((d,), ("act_embed",), init="ones"),
        "wq": P((d, cfg.n_heads * hd), ("embed", "heads"), init="scaled"),
        "wk": P((d, cfg.n_kv_heads * hd), ("embed", "kv_heads"),
                init="scaled"),
        "wv": P((d, cfg.n_kv_heads * hd), ("embed", "kv_heads"),
                init="scaled"),
        "wo": P((cfg.n_heads * hd, d), ("heads", "embed"), init="scaled"),
        "ln2": P((d,), ("act_embed",), init="ones"),
        "router": P((d, m.num_experts), ("embed", None), init="scaled"),
        "w_gate": P((m.e_pad, d, m.d_expert),
                    ("experts", "embed", "mlp"), init="scaled"),
        "w_up": P((m.e_pad, d, m.d_expert),
                  ("experts", "embed", "mlp"), init="scaled"),
        "w_down": P((m.e_pad, m.d_expert, d),
                    ("experts", "mlp", "embed"), init="scaled"),
    }


def schema(cfg) -> Dict[str, Any]:
    v = padded_vocab(cfg)
    s: Dict[str, Any] = {
        "embedding": P((v, cfg.d_model), ("vocab", "embed")),
        "ln_f": P((cfg.d_model,), ("act_embed",), init="ones"),
        "layers": stacked(cfg.n_layers, layer_schema(cfg)),
    }
    if not cfg.tie_embeddings:
        s["unembedding"] = P((v, cfg.d_model), ("vocab", "embed"))
    return s


def _block(params, x, cfg, *, positions, rules=None, cache=None):
    """Attention, then the routed FFN; returns (x, new_cache, aux)."""
    attn, new_cache = L.gqa_block(params, x, cfg, positions=positions,
                                  rules=rules, cache=cache,
                                  sliding_window=cfg.sliding_window)
    x = x + attn
    moe_out, aux = L.moe_block({**params, "ln": params["ln2"]}, x, cfg,
                               rules=rules)
    return x + moe_out, new_cache, aux


def forward(params, batch, cfg, rules=None, return_aux: bool = False):
    tokens = batch["tokens"]
    x = L.embed(params, tokens, cfg, rules)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]

    def body(p, x):
        x, _, aux = _block(p, x, cfg, positions=positions, rules=rules)
        return x, aux

    # under remat the recompute routes as the forward did: the same layer
    # input gives the same router logits, and "dots" keeps them
    body = remat(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for p in layer_views(params["layers"]):
        x, aux_l = body(p, x)
        aux = aux + aux_l
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.unembed(params, x, cfg, rules)
    if return_aux:
        return logits, aux
    return logits


# ------------------------------------------------------------------ decode
def cache_spec(cfg, batch: int, max_len: int) -> Dict[str, P]:
    return attn_cache_spec(cfg, batch, decode_window(cfg, max_len))


def decode_step(params, cache, batch, cfg, rules=None):
    """One token: batch = {"tokens": [B, 1], "pos": [B]}.  Returns (logits
    [B, 1, V], cache); the cache's tensors are updated in place.  The
    capacity is the decode batch's (B·k/E·capacity_factor), so decode
    drops choices that a forward over the whole sequence keeps, as in the
    JAX package."""
    x = L.embed(params, batch["tokens"], cfg, rules)
    pos = batch["pos"]
    for i in range(cfg.n_layers):
        x, _, _ = _block(layer(params, i), x, cfg, positions=pos,
                         rules=rules, cache=(cache["k"][i], cache["v"][i],
                                cache["key_pos"][i]))
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.unembed(params, x, cfg, rules), cache
