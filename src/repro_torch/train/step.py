"""Train, serve and prefill step builders (the port of the JAX package's
``train/step.py``).

`make_train_step` returns (state, batch) -> (state, metrics), with
optional gradient accumulation over microbatches: activation memory scales
with batch/accum_steps while the gradient sum stays whole.  The state is
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

from ..models.common import resolve_device, tree_map
from ..models.layers import cross_entropy
from . import optimizer as opt


@dataclass(frozen=True)
class TrainHyper:
    adamw: opt.AdamWConfig = opt.AdamWConfig()
    accum_steps: int = 1            # gradient-accumulation microbatches


def make_loss_fn(model) -> Callable:
    """(params, batch) -> (loss, {"ce", "aux"}); aux is 0 without MoE."""
    cfg = model.cfg
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: the MoE loss and its aux "
                                  "term come with the MoE slice")

    def loss_fn(params, batch):
        loss = cross_entropy(model.forward(params, batch), batch["labels"])
        return loss, {"ce": loss, "aux": torch.zeros_like(loss)}

    return loss_fn


def init_state(model, seed_or_generator: Union[int, torch.Generator] = 0,
               device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    params = model.init(seed_or_generator, device=device)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=resolve_device(device))}


def make_grad_fn(model, hyper: TrainHyper = TrainHyper()) -> Callable:
    """(params, batch) -> (loss, parts, grads), the gradient half of the
    train step: grads are fp32, like the params, in their tree.  With
    ``accum_steps = k`` the batch splits into k microbatches
    (``x.reshape(k, B/k, ...)``), grads and loss are summed over them and
    divided by k, and parts is empty, as in the JAX package."""
    loss_fn = make_loss_fn(model)
    k = hyper.accum_steps

    def single(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, parts = loss_fn(live, batch)
        flat = opt.leaves(live)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return (loss.detach(), {n: v.detach() for n, v in parts.items()},
                opt.unflatten(params, grads))

    def accumulated(params, batch):
        mbs = {n: x.reshape((k, x.shape[0] // k) + x.shape[1:])
               for n, x in batch.items()}
        grads, loss = None, 0.0
        for i in range(k):
            mb_loss, _, mb_grads = single(params, {n: x[i] for n, x
                                                   in mbs.items()})
            loss = loss + mb_loss
            if grads is None:
                grads = mb_grads
            else:
                for acc, g in zip(opt.leaves(grads), opt.leaves(mb_grads)):
                    acc.add_(g)
            del mb_grads
        for g in opt.leaves(grads):
            g.div_(k)
        return loss / k, {}, grads

    return accumulated if k > 1 else single


def make_train_step(model, hyper: TrainHyper = TrainHyper()) -> Callable:
    grad_fn = make_grad_fn(model, hyper)

    def train_step(state, batch):
        loss, parts, grads = grad_fn(state["params"], batch)
        params, opt_state, om = opt.update(hyper.adamw, grads, state["opt"],
                                           state["params"])
        metrics = {"loss": loss, **parts, **om}
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1}, metrics)

    return train_step


def make_serve_step(model) -> Callable:
    def serve_step(params, cache, batch):
        logits, cache = model.decode_step(params, cache, batch)
        return logits[:, -1].argmax(dim=-1).to(torch.int32), cache

    return serve_step


def make_prefill_step(model) -> Callable:
    def prefill(params, batch):
        logits = model.forward(params, batch)
        return logits[:, -1].argmax(dim=-1).to(torch.int32)

    return prefill
