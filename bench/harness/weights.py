"""The benchmark's model inputs: a configuration file, and weights drawn
from the run's seed on the device.

The weights are the benchmark's, not the program's: they are drawn here,
one ``torch.randn`` per leaf of the stacked tree that the configuration's
family gives (ten or so large calls), in the type they are served or
trained in, and handed alike to the program and to the reference.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict

import torch

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def load_config(name: str) -> Dict:
    with open(os.path.join(CONFIG_DIR, f"{name}.json")) as f:
        return json.load(f)


@torch.no_grad()
def draw(shapes: Dict[str, tuple], seed: int, dtype: torch.dtype,
         device: torch.device) -> Dict:
    """The parameter tree of ``shapes`` (a family's: each leaf's path,
    shape and kind), drawn from ``seed`` on ``device`` in ``dtype``, in
    the order of ``shapes``: fan-in scaled normal, embedding normal, or a
    norm scale near 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = {}
    for name, (shape, kind) in shapes.items():
        t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        if kind == "fan_in":
            t.mul_(1.0 / math.sqrt(shape[-2]))
        elif kind == "embed":
            t.mul_(0.02)
        else:
            t.mul_(0.1).add_(1.0)
        flat[name] = t
    return tree(flat)


def tree(flat: Dict) -> Dict:
    """The stacked tree of leaves by path: ``layers/<leaf>`` under
    ``layers`` (first), the others at the top."""
    out: Dict = {"layers": {}}
    for k, v in flat.items():
        if k.startswith("layers/"):
            out["layers"][k[len("layers/"):]] = v
        else:
            out[k] = v
    return out


def leaves(tree: Dict, prefix: str = "") -> Dict:
    """A nested tree's leaves by path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out
