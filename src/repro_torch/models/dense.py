"""Dense GQA transformer (mistral-large / command-r / qwen2 / smollm) and
the LLaVA VLM backbone (dense + projected patch embeddings), in plain
PyTorch.

Sequential pre-norm blocks by default; `parallel_block=True` (command-r)
computes attention and FFN from one shared norm and sums the branches.
The JAX package's `lax.scan` over the stacked layer axis is a Python loop
here, under the config's remat policy.  Decode runs one token against the
ring KV cache of `cache_spec`, written in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..parallel.sharding import logical_constraint as lc
from . import layers as L
from .common import (P, attn_cache_spec, decode_specs, decode_window,
                     layer_views, padded_vocab, remat, stacked, to_dtype,
                     token_specs)


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
    if cfg.parallel_block:
        del s["ln2"]                      # one shared norm per block
    return s


def schema(cfg) -> Dict[str, Any]:
    v = padded_vocab(cfg)
    s: Dict[str, Any] = {
        "embedding": P((v, cfg.d_model), ("vocab", "embed")),
        "ln_f": P((cfg.d_model,), ("act_embed",), init="ones"),
        "layers": stacked(cfg.n_layers, layer_schema(cfg)),
    }
    if not cfg.tie_embeddings:
        s["unembedding"] = P((v, cfg.d_model), ("vocab", "embed"))
    if cfg.vlm is not None:
        s["vision_proj"] = P((cfg.vlm.vision_dim, cfg.d_model),
                             (None, "embed"), init="scaled")
    return s


def _block(params, x, cfg, *, positions, rules=None, cache=None,
           sliding_window=None):
    """One transformer block; returns (x, new_cache)."""
    if cfg.parallel_block:
        y = L.rms_norm(x, params["ln"], cfg.norm_eps)
        attn, new_cache = L.gqa_block(params, y, cfg, positions=positions,
                                      rules=rules, cache=cache, norm=False,
                                      sliding_window=sliding_window)
        return x + attn + L.swiglu(params, y, cfg, rules=rules,
                                   pre_normed=True), new_cache
    attn, new_cache = L.gqa_block(params, x, cfg, positions=positions,
                                  rules=rules, cache=cache,
                                  sliding_window=sliding_window)
    x = x + attn
    return x + L.swiglu({**params, "ln": params["ln2"]}, x, cfg,
                        rules=rules), new_cache


def _embed_inputs(params, batch, cfg, rules=None):
    """Token embeddings and their positions, with the projected patch
    embeddings [B, P, vision_dim] prepended for the VLM backbone (the
    vision tower itself is a stub, as in the JAX package)."""
    tokens = batch["tokens"]
    x = L.embed(params, tokens, cfg, rules)
    if cfg.vlm is not None and "patch_embeds" in batch:
        dt = to_dtype(cfg.compute_dtype)
        patches = L.cast(batch["patch_embeds"], dt) \
            @ L.cast(params["vision_proj"], dt)
        patches = lc(patches, ("batch", "seq", "act_embed"), rules)
        x = torch.cat([patches, x], dim=1)
    positions = torch.arange(x.shape[1], device=tokens.device)[None, :]
    return x, positions


def layer(params, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s parameters: views into the stacked tree."""
    return {k: v[i] for k, v in params["layers"].items()}


def forward(params, batch, cfg, rules=None) -> torch.Tensor:
    x, positions = _embed_inputs(params, batch, cfg, rules)

    def body(p, x):
        return _block(p, x, cfg, positions=positions, rules=rules,
                      sliding_window=cfg.sliding_window)[0]

    body = remat(body, cfg)
    for p in layer_views(params["layers"]):
        x = body(p, x)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.unembed(params, x, cfg, rules)
    if cfg.vlm is not None and "patch_embeds" in batch:
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    return logits


# ------------------------------------------------------------------ decode
def cache_spec(cfg, batch: int, max_len: int) -> Dict[str, P]:
    return attn_cache_spec(cfg, batch, decode_window(cfg, max_len))


def decode_step(params, cache, batch, cfg, rules=None):
    """One token: batch = {"tokens": [B, 1], "pos": [B]}.  Returns (logits
    [B, 1, V], cache); the cache's tensors are updated in place."""
    x = L.embed(params, batch["tokens"], cfg, rules)
    pos = batch["pos"]
    for i in range(cfg.n_layers):
        x, _ = _block(layer(params, i), x, cfg, positions=pos, rules=rules,
                      cache=(cache["k"][i], cache["v"][i],
                             cache["key_pos"][i]),
                      sliding_window=cfg.sliding_window)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.unembed(params, x, cfg, rules), cache


def input_specs(cfg, shape) -> Dict[str, torch.Tensor]:
    """The step's inputs at ``shape`` as meta tensors."""
    if shape.kind == "decode":
        return decode_specs(shape.global_batch)
    specs = token_specs(shape.global_batch, shape.seq_len)
    if cfg.vlm is not None:
        specs["patch_embeds"] = torch.empty(
            (shape.global_batch, cfg.vlm.num_patches, cfg.vlm.vision_dim),
            dtype=to_dtype(cfg.compute_dtype), device="meta")
    return specs
