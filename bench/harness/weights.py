"""The benchmark's model inputs: a configuration file, and weights drawn
from the run's seed on the device.

The weights are the benchmark's, not the program's: they are drawn here,
one ``torch.randn`` per leaf of the stacked tree (ten or so large calls),
in the type they are served or trained in, and handed alike to the program
and to the reference.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict

import torch

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")

# the published config's keys → the model's sizes as the harness and the
# reference name them
KEYS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
        "num_hidden_layers": "n_layers", "num_attention_heads": "n_heads",
        "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
        "vocab_size": "vocab", "rope_theta": "rope_theta",
        "rms_norm_eps": "norm_eps", "tie_word_embeddings": "tie_embeddings"}


def load_config(name: str) -> Dict:
    with open(os.path.join(CONFIG_DIR, f"{name}.json")) as f:
        return json.load(f)


def sizes(config: Dict) -> Dict:
    """The model's sizes under the harness's names."""
    return {ours: config[theirs] for theirs, ours in KEYS.items()}


def shapes(m: Dict) -> Dict[str, tuple]:
    """Every leaf of the dense model's stacked parameter tree: its shape,
    and how it is drawn (fan-in scaled normal, embedding normal, or a norm
    scale near 1)."""
    d, hd, n = m["d_model"], m["head_dim"], m["n_layers"]
    out = {
        "embedding": ((m["vocab"], d), "embed"),
        "ln_f": ((d,), "norm"),
        "layers/ln": ((n, d), "norm"),
        "layers/ln2": ((n, d), "norm"),
        "layers/wq": ((n, d, m["n_heads"] * hd), "fan_in"),
        "layers/wk": ((n, d, m["n_kv_heads"] * hd), "fan_in"),
        "layers/wv": ((n, d, m["n_kv_heads"] * hd), "fan_in"),
        "layers/wo": ((n, m["n_heads"] * hd, d), "fan_in"),
        "layers/w_gate": ((n, d, m["d_ff"]), "fan_in"),
        "layers/w_up": ((n, d, m["d_ff"]), "fan_in"),
        "layers/w_down": ((n, m["d_ff"], d), "fan_in"),
    }
    if not m["tie_embeddings"]:
        out["unembedding"] = ((m["vocab"], d), "embed")
    return out


@torch.no_grad()
def draw(m: Dict, seed: int, dtype: torch.dtype,
         device: torch.device) -> Dict:
    """The parameter tree (``{"embedding", "ln_f", "layers": {...}}``)
    drawn from ``seed`` on ``device`` in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tree: Dict = {"layers": {}}
    for name, (shape, kind) in shapes(m).items():
        t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        if kind == "fan_in":
            t.mul_(1.0 / math.sqrt(shape[-2]))
        elif kind == "embed":
            t.mul_(0.02)
        else:
            t.mul_(0.1).add_(1.0)
        if name.startswith("layers/"):
            tree["layers"][name[len("layers/"):]] = t
        else:
            tree[name] = t
    return tree
