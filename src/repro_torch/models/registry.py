"""Architecture registry of the port: ModelConfig.arch_kind → model module."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Union

import numpy as np
import torch

from ..parallel.sharding import abstract_params
from . import dense, mamba2, mla_moe, moe, whisper, xlstm
from .common import P, init_params, resolve_device

_MODULES = {
    "dense": dense,
    "vlm": dense,                   # LLaVA backbone = dense + patch proj
    "moe": moe,
    "mla_moe": mla_moe,             # latent attention, DeepSeek-V3 experts
    "mamba2_hybrid": mamba2,
    "xlstm": xlstm,
    "whisper": whisper,
}


@dataclass(frozen=True)
class Model:
    cfg: Any
    module: Any

    def schema(self) -> Any:
        return self.module.schema(self.cfg)

    def abstract_params(self) -> Any:
        """The params as meta tensors (no storage), for the dry-run."""
        return abstract_params(self.schema(), self.cfg.param_dtype)

    def init(self, seed_or_generator: Union[int, torch.Generator] = 0,
             device: Union[str, torch.device] = "cuda") -> Any:
        """Random params on ``device`` from a seed or a generator that lives
        on that device."""
        dev = resolve_device(device)
        if isinstance(seed_or_generator, torch.Generator):
            gen = seed_or_generator
        else:
            gen = torch.Generator(device=dev).manual_seed(seed_or_generator)
        return init_params(self.schema(), gen, self.cfg.param_dtype, dev)

    def param_count(self) -> int:
        """Exact parameter count, derived from the schema."""
        def count(node):
            if isinstance(node, P):
                return int(np.prod(node.shape))
            return sum(count(v) for v in node.values())
        return count(self.schema())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k of the expert FFNs held,
        in the layers that have experts)."""
        m = self.cfg.moe
        if m is None:
            return self.param_count()
        expert = 3 * self.cfg.d_model * m.d_expert \
            * (self.cfg.n_layers - self.cfg.first_k_dense)
        return self.param_count() - expert * max(m.n_held - m.top_k, 0)

    def frozen(self) -> frozenset:
        """Paths ("layers/router_bias") of the leaves that the train step
        leaves as they are (`P.trainable` False)."""
        def walk(node, prefix):
            if isinstance(node, P):
                return [] if node.trainable else [prefix]
            return [p for k, v in node.items()
                    for p in walk(v, f"{prefix}/{k}" if prefix else k)]
        return frozenset(walk(self.schema(), ""))

    def forward(self, params, batch, rules=None) -> torch.Tensor:
        return self.module.forward(params, batch, self.cfg, rules=rules)

    def decode_step(self, params, cache, batch, rules=None):
        """One token against ``cache``, which it updates in place."""
        return self.module.decode_step(params, cache, batch, self.cfg,
                                       rules=rules)

    def cache_schema(self, batch: int, max_len: int) -> Any:
        return self.module.cache_spec(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int,
                   device: Union[str, torch.device] = "cuda") -> Any:
        """An empty decode cache on ``device``, as its schema's init modes
        say (zeros; key_pos -1; xLSTM's stabiliser -1e30, its sLSTM
        normaliser 1e-6)."""
        return init_params(self.cache_schema(batch, max_len), None,
                           self.cfg.compute_dtype, resolve_device(device))

    def abstract_cache(self, batch: int, max_len: int) -> Any:
        """The decode cache as meta tensors."""
        return abstract_params(self.cache_schema(batch, max_len),
                               self.cfg.compute_dtype)

    def input_specs(self, shape) -> Dict[str, torch.Tensor]:
        """The inputs of the step of ``shape`` (a `ShapeConfig`) as meta
        tensors."""
        return self.module.input_specs(self.cfg, shape)


def get_model(cfg) -> Model:
    if cfg.arch_kind not in _MODULES:
        raise KeyError(f"unknown arch_kind {cfg.arch_kind!r}; known: "
                       f"{sorted(_MODULES)}")
    return Model(cfg, _MODULES[cfg.arch_kind])
