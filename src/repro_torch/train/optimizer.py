"""AdamW with fp32 moments (params are kept fp32 — the models cast to the
compute dtype at use, so the params themselves are the master copy), the
port of the JAX package's ``train/optimizer.py``.

`init` builds the moment trees; `update` takes the gradients and returns
the new params, state and metrics.  Unlike the JAX package's pure
`update`, it writes the params and moments in place and returns those
same tensors (one copy of each on the card, no new allocation per step).
Every scalar (count, lr, bias corrections, clip scale) stays a 0-d tensor
on the params' device: nothing waits for the card until the caller reads
a metric.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..models.common import tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    """A NamedTuple, as in the JAX package, so checkpoint paths read
    ``opt/0`` (m), ``opt/1`` (v), ``opt/2`` (count)."""
    m: Any
    v: Any
    count: torch.Tensor


def leaves(tree: Any) -> list:
    """The tensors of a nested dict in sorted key order (the JAX package's
    leaf order), so that trees built in other key orders line up."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def without(tree: Any, drop: frozenset, prefix: str = "") -> Any:
    """``tree`` less the leaves at the paths ("layers/router_bias") in
    ``drop``: new dicts holding the same tensors, or ``tree`` itself
    where ``drop`` is empty."""
    if not drop:
        return tree
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = without(v, drop, f"{prefix}{k}/")
        elif f"{prefix}{k}" not in drop:
            out[k] = v
    return out


def unflatten(template: Any, flat: list) -> Any:
    """``template``'s tree (and key order) with the tensors of ``flat``,
    given in `leaves` order."""
    it = iter(flat)

    def build(node):
        if not isinstance(node, dict):
            return next(it)
        out = {k: build(node[k]) for k in sorted(node)}
        return {k: out[k] for k in node}

    return build(template)


def init(params: Any) -> OptState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    count_device = leaves(params)[0].device
    return OptState(m=zeros, v=tree_map(torch.zeros_like, zeros),
                    count=torch.zeros((), dtype=torch.int32,
                                      device=count_device))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio·lr (fp32)."""
    step = step.float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.decay_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Any, state: OptState,
           params: Any) -> Tuple[Any, OptState, dict]:
    """One AdamW step; ``grads`` has the structure of ``params``.  The
    params and the moments are updated in place."""
    count = state.count + 1
    gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip is not None:
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    lr = schedule(cfg, count)
    c = count.float()
    bc1 = 1 - torch.pow(cfg.b1, c)
    bc2 = 1 - torch.pow(cfg.b2, c)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        g = g.float()
        if scale is not None:
            g = g * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        # decay on every leaf of 2 dims or more, as the JAX package's code
        # does: on the stacked tree that takes in the [L, d] norm scales
        # and the [L, n] biases too (its comment says otherwise)
        if p.ndim >= 2:
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(state.m, state.v, count), metrics
