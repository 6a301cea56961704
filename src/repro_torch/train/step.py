"""Train, serve and prefill step builders (the port of the JAX package's
``train/step.py``).

`make_train_step` returns (state, batch) -> (state, metrics), with
optional gradient accumulation over microbatches: activation memory scales
with batch/accum_steps while the gradient sum stays whole.  The leaves the
model keeps out of training (`Model.frozen`: Moonlight's routing bias) are
left out of the optimizer's trees, so no step or decay reaches them.  The state is
``{"params", "opt", "step"}``; the params and moments are updated in place
and the returned state holds the same tensors.  The metrics are 0-d
tensors on the card: reading one waits for the step.

`make_prefill_step` returns (params, batch) -> next tokens [B] int32, the
greedy token after a full-sequence forward; `make_serve_step` returns
(params, cache, batch) -> (next tokens [B] int32, cache), one decode step
against the cache of ``Model.init_cache``, which it updates in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Union

import torch
from torch.distributed.tensor import DTensor

from .. import trace
from ..models.common import resolve_device, tree_map
from ..models.layers import cross_entropy
from ..parallel.sharding import last_row, redistribute, whole_on
from . import optimizer as opt


@dataclass(frozen=True)
class TrainHyper:
    adamw: opt.AdamWConfig = opt.AdamWConfig()
    accum_steps: int = 1            # gradient-accumulation microbatches


def make_loss_fn(model, rules=None) -> Callable:
    """(params, batch) -> (ce + aux, {"ce", "aux"}): aux is the MoE
    router's load-balancing loss summed over the layers, 0 without MoE."""
    cfg = model.cfg

    def loss_fn(params, batch):
        if cfg.moe is None:
            ce = cross_entropy(model.forward(params, batch, rules),
                               batch["labels"])
            return ce, {"ce": ce, "aux": torch.zeros_like(ce)}
        logits, aux = model.module.forward(params, batch, cfg, rules=rules,
                                           return_aux=True)
        ce = cross_entropy(logits, batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}

    return loss_fn


def init_state(model, seed_or_generator: Union[int, torch.Generator] = 0,
               device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    params = model.init(seed_or_generator, device=device)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=resolve_device(device))}


def abstract_state(model) -> Dict[str, Any]:
    """`init_state`'s tree as meta tensors (no storage), for the dry-run:
    the params in their dtype, fp32 moments, int32 count and step."""
    params = model.abstract_params()
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32,  # noqa: E731
                                device="meta")
    scalar = lambda: torch.empty((), dtype=torch.int32,  # noqa: E731
                                 device="meta")
    return {"params": params,
            "opt": opt.OptState(m=tree_map(f32, params),
                                v=tree_map(f32, params), count=scalar()),
            "step": scalar()}


def make_grad_fn(model, hyper: TrainHyper = TrainHyper(),
                 rules=None) -> Callable:
    """(params, batch) -> (loss, parts, grads), the gradient half of the
    train step: grads are fp32, like the params, in their tree.  With
    ``accum_steps = k`` the batch splits into k microbatches
    (``x.reshape(k, B/k, ...)``), grads and loss are summed over them and
    divided by k, and parts is empty, as in the JAX package; an MoE
    microbatch routes with its own capacity and aux loss."""
    loss_fn = make_loss_fn(model, rules)
    k = hyper.accum_steps

    def single(params, batch, into=None):
        """One microbatch's loss and grads; ``into``: the leaves of a
        gradient sum, to which its grads are added."""
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with trace.span("train.forward", device=True):
            loss, parts = loss_fn(live, batch)
        with trace.span("train.backward", device=True):
            flat = opt.leaves(live)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(flat, grads)]
            for acc, g in zip(into or (), grads):
                acc.add_(g)
        return (loss.detach(), {n: v.detach() for n, v in parts.items()},
                opt.unflatten(params, grads))

    def microbatch(x, i):
        """Rows [i·B/k, (i+1)·B/k) of the global batch ``x``.  A DTensor
        is made whole first and its rows placed as ``x`` is: DTensor's
        view of a dim sharded on two mesh dims gives wrong local shapes,
        and splitting each rank's shard would change which rows make up
        a microbatch (an MoE step's capacity, drops and aux loss)."""
        mb = whole_on(x, 0).reshape((k, x.shape[0] // k) + x.shape[1:])[i]
        return redistribute(mb, x.placements) if isinstance(x, DTensor) \
            else mb

    def accumulated(params, batch):
        grads, loss = None, 0.0
        for i in range(k):
            mb_loss, _, mb_grads = single(params, {
                n: microbatch(x, i) for n, x in batch.items()},
                into=None if grads is None else opt.leaves(grads))
            loss = loss + mb_loss
            if grads is None:
                grads = mb_grads
            del mb_grads
        for g in opt.leaves(grads):
            g.div_(k)
        return loss / k, {}, grads

    return accumulated if k > 1 else single


def make_train_step(model, hyper: TrainHyper = TrainHyper(),
                    rules=None) -> Callable:
    grad_fn = make_grad_fn(model, hyper, rules)
    frozen = model.frozen()

    def trained(tree):
        return opt.without(tree, frozen)

    def train_step(state, batch):
        with trace.span("train.step", tokens=batch["tokens"].numel()):
            loss, parts, grads = grad_fn(state["params"], batch)
            with trace.span("train.optimizer", device=True):
                o = state["opt"]
                # in place: the returned trees hold the tensors passed
                _, new, om = opt.update(
                    hyper.adamw, trained(grads),
                    opt.OptState(trained(o.m), trained(o.v), o.count),
                    trained(state["params"]))
                params, opt_state = state["params"], \
                    opt.OptState(o.m, o.v, new.count)
        metrics = {"loss": loss, **parts, **om}
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1}, metrics)

    return train_step


def _argmax(row: torch.Tensor) -> torch.Tensor:
    """The greedy token of each logit row [B, V], int32; on a mesh the
    vocab is gathered first (DTensor's argmax over a sharded dim fails
    where the batch is sharded on two mesh dims)."""
    return whole_on(row, -1).argmax(dim=-1).to(torch.int32)


def make_serve_step(model, rules=None) -> Callable:
    def serve_step(params, cache, batch):
        logits, cache = model.decode_step(params, cache, batch, rules)
        return _argmax(logits[:, -1]), cache

    return serve_step


def make_prefill_step(model, rules=None) -> Callable:
    def prefill(params, batch):
        logits = model.forward(params, batch, rules)
        return _argmax(last_row(logits))

    return prefill
