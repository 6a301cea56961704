"""Config registry of the port: ``--arch <id>`` → ModelConfig.

Every arch of the JAX package, in its order (``ARCHS``, the dry-run's
cells), then the archs of the port alone (``PORT_ARCHS``).  Each module
exports CONFIG (the published configuration) and smoke() (a reduced
same-family config for CPU tests), as in the JAX package.
"""
from typing import List

from .base import SHAPES, ModelConfig, ShapeConfig

from . import (command_r_35b, granite_moe_3b_a800m, llava_next_34b,
               mistral_large_123b, moonlight_16b_a3b, olmoe_1b_7b, qwen2_7b,
               smollm_360m, whisper_medium, xlstm_1p3b, zamba2_1p2b)

_MODULES = {
    "mistral-large-123b": mistral_large_123b,
    "command-r-35b": command_r_35b,
    "qwen2-7b": qwen2_7b,
    "smollm-360m": smollm_360m,
    "llava-next-34b": llava_next_34b,
    "zamba2-1.2b": zamba2_1p2b,
    "xlstm-1.3b": xlstm_1p3b,
    "whisper-medium": whisper_medium,
    "olmoe-1b-7b": olmoe_1b_7b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
}

ARCHS: List[str] = list(_MODULES)

# no JAX config beside them, so no dry-run cell
_PORT_MODULES = {
    "moonlight-16b-a3b": moonlight_16b_a3b,
}
PORT_ARCHS: List[str] = list(_PORT_MODULES)


def _module(name: str):
    mod = _MODULES.get(name) or _PORT_MODULES.get(name)
    if mod is None:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{ARCHS + PORT_ARCHS}")
    return mod


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells():
    """All (arch, shape) dry-run cells, with skip rationale for the
    impossible ones (documented in DESIGN.md §Arch-applicability)."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            skip = None
            if sname == "long_500k" and not cfg.subquadratic:
                skip = ("full-attention architecture: 500k decode needs "
                        "sub-quadratic attention (see DESIGN.md)")
            out.append((arch, sname, skip))
    return out


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCHS", "PORT_ARCHS",
           "get_config", "get_smoke_config", "get_shape", "cells"]
