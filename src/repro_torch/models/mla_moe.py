"""DeepSeek-V3 blocks (Moonlight-16B-A3B) in plain PyTorch: multi-head
latent attention, then the first ``first_k_dense`` layers a SwiGLU and
the rest DeepSeek-V3's experts (sigmoid routing with a correction bias,
shared experts, the sequence-wise balance loss; `layers.moe_block`), of
which the device may hold a share (expert parallelism's, one rank).

The MoE layers are stacked under ``layers``; the leading dense layers'
leaves sit at the top of the tree as ``dense_<leaf>`` [first_k_dense,
...], a stack of their own.  The correction bias ``layers/router_bias``
is not trained (`P.trainable`): only selection reads it.  The router's
balance loss is summed over the layers and returned to the loss by
``forward(..., return_aux=True)``.  Train and prefill only: decode would
need a latent cache.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import layers as L
from .common import P, layer_views, padded_vocab, remat, stacked
from .dense import input_specs  # noqa: F401

DENSE = "dense_"


def attn_schema(cfg) -> Dict[str, P]:
    d, h, a = cfg.d_model, cfg.n_heads, cfg.mla
    return {
        "ln": P((d,), ("act_embed",), init="ones"),
        "wq": P((d, h * a.qk_dim), ("embed", "heads"), init="scaled"),
        "wkva": P((d, a.kv_rank + a.qk_rope), ("embed", None),
                  init="scaled"),
        "kv_ln": P((a.kv_rank,), (None,), init="ones"),
        "wkvb": P((a.kv_rank, h * (a.qk_nope + a.v_dim)), (None, "heads"),
                  init="scaled"),
        "wo": P((h * a.v_dim, d), ("heads", "embed"), init="scaled"),
        "ln2": P((d,), ("act_embed",), init="ones"),
    }


def dense_schema(cfg) -> Dict[str, P]:
    d = cfg.d_model
    return {**attn_schema(cfg),
            "w_gate": P((d, cfg.d_ff), ("embed", "mlp"), init="scaled"),
            "w_up": P((d, cfg.d_ff), ("embed", "mlp"), init="scaled"),
            "w_down": P((cfg.d_ff, d), ("mlp", "embed"), init="scaled")}


def layer_schema(cfg) -> Dict[str, P]:
    d, m = cfg.d_model, cfg.moe
    return {
        **attn_schema(cfg),
        "router": P((d, m.num_experts), ("embed", None), init="scaled"),
        "router_bias": P((m.num_experts,), (None,), init="zeros",
                         trainable=False),
        "w_gate": P((m.n_held, d, m.d_expert),
                    ("experts", "embed", "mlp"), init="scaled"),
        "w_up": P((m.n_held, d, m.d_expert),
                  ("experts", "embed", "mlp"), init="scaled"),
        "w_down": P((m.n_held, m.d_expert, d),
                    ("experts", "mlp", "embed"), init="scaled"),
        "shared_gate": P((d, m.d_shared), ("embed", "mlp"), init="scaled"),
        "shared_up": P((d, m.d_shared), ("embed", "mlp"), init="scaled"),
        "shared_down": P((m.d_shared, d), ("mlp", "embed"), init="scaled"),
    }


def schema(cfg) -> Dict[str, Any]:
    v = padded_vocab(cfg)
    s: Dict[str, Any] = {
        "embedding": P((v, cfg.d_model), ("vocab", "embed")),
        "ln_f": P((cfg.d_model,), ("act_embed",), init="ones"),
        "layers": stacked(cfg.n_layers - cfg.first_k_dense,
                          layer_schema(cfg)),
    }
    s.update({DENSE + k: p for k, p in
              stacked(cfg.first_k_dense, dense_schema(cfg)).items()})
    if not cfg.tie_embeddings:
        s["unembedding"] = P((v, cfg.d_model), ("vocab", "embed"))
    return s


def dense_layers(params) -> Dict[str, torch.Tensor]:
    """The leading dense layers' stacked leaves, by leaf name."""
    return {k[len(DENSE):]: v for k, v in params.items()
            if k.startswith(DENSE)}


def forward(params, batch, cfg, rules=None, return_aux: bool = False):
    tokens = batch["tokens"]
    x = L.embed(params, tokens, cfg, rules)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]

    def dense_body(p, x):
        x = x + L.mla_block(p, x, cfg, positions=positions, rules=rules)
        return x + L.swiglu({**p, "ln": p["ln2"]}, x, cfg, rules=rules)

    def moe_body(p, x):
        x = x + L.mla_block(p, x, cfg, positions=positions, rules=rules)
        out, aux = L.moe_block({**p, "ln": p["ln2"]}, x, cfg, rules=rules)
        return x + out, aux

    dense_body, moe_body = remat(dense_body, cfg), remat(moe_body, cfg)
    if cfg.first_k_dense:
        for p in layer_views(dense_layers(params)):
            x = dense_body(p, x)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for p in layer_views(params["layers"]):
        x, aux_l = moe_body(p, x)
        aux = aux + aux_l
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.unembed(params, x, cfg, rules)
    if return_aux:
        return logits, aux
    return logits


def cache_spec(cfg, batch: int, max_len: int):
    raise NotImplementedError("mla_moe: no decode cache (MLA decode needs "
                              "a latent cache)")


def decode_step(params, cache, batch, cfg, rules=None):
    raise NotImplementedError("mla_moe: no decode step (MLA decode needs "
                              "a latent cache)")
