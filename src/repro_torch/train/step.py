"""Serving steps (the serving half of the JAX package's
``train/step.py``; the training half comes with the training slice).

`make_prefill_step` returns (params, batch) -> next tokens [B] int32, the
greedy token after a full-sequence forward; `make_serve_step` returns
(params, cache, batch) -> (next tokens [B] int32, cache), one decode step
against the cache of ``Model.init_cache``, which it updates in place.
"""
from __future__ import annotations

from typing import Callable

import torch


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
