"""Shared scaffolding of the port's models: declarative parameter specs,
their materialization, and the device rule of every entry point.

Layer parameters are stacked along a leading "layers" axis, as in the JAX
package, so a parameter tree maps one to one between the two packages (see
`repro_torch.weights`).  The forward pass loops over that axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

VOCAB_PAD = 128

Axes = Tuple[Optional[str], ...]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU: a
    CUDA device on a machine without one raises instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA card; "
            "pass device='cpu' to run on the CPU")
    return dev


def to_dtype(name: str) -> torch.dtype:
    """Config dtype name ("float32", "bfloat16", ...) → torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclass(frozen=True)
class P:
    """Declarative parameter spec (shape, logical axes, init)."""
    shape: Tuple[int, ...]
    axes: Axes                      # logical axis names, len == len(shape)
    init: str = "normal"            # normal | scaled | zeros | ones |
                                    # neg_ones | neg_large | eps
    scale: float = 1.0
    dtype: Optional[str] = None     # override the config param_dtype
    trainable: bool = True          # False: the train step leaves it as
                                    # it is (no gradient step, no decay)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def padded_vocab(cfg) -> int:
    """Embedding tables are padded to a multiple of 128, as in the JAX
    package, so logits keep its [B, S, padded_vocab] shape."""
    return -(-cfg.vocab // VOCAB_PAD) * VOCAB_PAD


def stacked(n_layers: int, sub: Dict[str, P]) -> Dict[str, P]:
    """Add a leading "layers" axis to every P in a per-layer schema."""
    return {k: P((n_layers,) + p.shape, ("layers",) + p.axes, init=p.init,
                 scale=p.scale, dtype=p.dtype, trainable=p.trainable)
            for k, p in sub.items()}


def layer_views(layers: Dict[str, torch.Tensor]
                ) -> List[Dict[str, torch.Tensor]]:
    """Each layer's parameters as views into the stacked tree, unbound once:
    the backward of `unbind` stacks the layers' gradients in one copy,
    where indexing per layer would add a full-size zero gradient per
    layer."""
    parts = {k: v.unbind(0) for k, v in layers.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def group_views(groups: Dict[str, torch.Tensor]
                ) -> List[List[Dict[str, torch.Tensor]]]:
    """`layer_views` of a tree stacked twice, [G, K, ...] (xLSTM's mLSTM
    layers, K per group): G lists of K layers' views."""
    parts = {k: v.unbind(0) for k, v in groups.items()}
    n = len(next(iter(parts.values())))
    return [layer_views({k: v[g] for k, v in parts.items()})
            for g in range(n)]


# matmul outputs, which remat "dots" keeps (JAX's `checkpoint_dots`)
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default]


def remat(body: Callable, cfg) -> Callable:
    """``body`` under the config's remat policy, the port's `scan_layers`
    (the JAX package wraps its scan body in `jax.checkpoint`): "full"
    keeps only the layer's inputs and recomputes the rest in backward,
    "dots" also keeps the matmul outputs; "none", or grad off, runs the
    body as it is."""
    if cfg.remat not in ("full", "dots"):
        return body
    context_fn = (partial(create_selective_checkpoint_contexts, _DOTS)
                  if cfg.remat == "dots" else noop_context_fn)

    def run(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return checkpoint(body, *args, use_reentrant=False,
                          context_fn=context_fn)

    return run


def attn_cache_spec(cfg, batch: int, window: int,
                    n_layers: Optional[int] = None) -> Dict[str, P]:
    """Ring-buffer KV cache schema, stacked on layers: k/v [L, B, W, Hkv,
    D] in the compute dtype, key_pos [L, B, W] int32 (-1 = empty)."""
    n_layers = cfg.n_layers if n_layers is None else n_layers
    kv = (n_layers, batch, window, cfg.n_kv_heads, cfg.head_dim_)
    kv_axes = ("layers", "batch", "window", "kv_heads", None)
    return {
        "k": P(kv, kv_axes, init="zeros", dtype=cfg.compute_dtype),
        "v": P(kv, kv_axes, init="zeros", dtype=cfg.compute_dtype),
        "key_pos": P((n_layers, batch, window),
                     ("layers", "batch", "window"), init="neg_ones",
                     dtype="int32"),
    }


def decode_window(cfg, max_len: int) -> int:
    """Cache width: the full history, or the sliding window if the config
    declares one."""
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


# the constant init modes: ring-cache key positions start at -1 (empty);
# xLSTM's stabilisers at -1e30 and its sLSTM normaliser at 1e-6
_FILL = {"zeros": 0, "ones": 1, "neg_ones": -1, "neg_large": -1e30,
         "eps": 1e-6}


def init_params(schema: Any, generator: Optional[torch.Generator],
                param_dtype: str, device: torch.device) -> Any:
    """Materialize a schema on ``device``, drawing from ``generator`` (which
    must live on that device; None for a schema with no random init).
    The JAX package's init rules; the numbers differ from JAX's, so parity
    tests carry JAX params across instead.  An init mode it does not know
    raises ``ValueError``."""
    def mk(p: P) -> torch.Tensor:
        dt = to_dtype(p.dtype or param_dtype)
        if p.init in _FILL:
            return torch.full(p.shape, _FILL[p.init], dtype=dt,
                              device=device)
        if p.init not in ("normal", "scaled"):
            raise ValueError(f"unknown init mode {p.init!r} of a {p.shape} "
                             "parameter")
        x = torch.randn(p.shape, generator=generator, dtype=dt,
                        device=device)
        if p.init == "scaled":     # fan-in scaled normal
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            return x.mul_(p.scale / np.sqrt(max(1, fan_in)))
        return x.mul_(0.02 * p.scale)

    def walk(node):
        if isinstance(node, P):
            return mk(node)
        return {k: walk(v) for k, v in node.items()}

    return walk(schema)


def token_specs(batch: int, seq: int) -> Dict[str, torch.Tensor]:
    """Train/prefill inputs as meta tensors (the JAX package's
    ShapeDtypeStructs)."""
    return {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                                  device="meta"),
            "labels": torch.empty((batch, seq), dtype=torch.int32,
                                  device="meta")}


def decode_specs(batch: int) -> Dict[str, torch.Tensor]:
    """Decode-step inputs as meta tensors."""
    return {"tokens": torch.empty((batch, 1), dtype=torch.int32,
                                  device="meta"),
            "pos": torch.empty((batch,), dtype=torch.int32, device="meta")}


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
