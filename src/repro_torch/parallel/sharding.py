"""Logical-axis sharding on DTensor (the port of the JAX package's
``parallel/sharding.py``).

Every parameter is declared once as a ``P`` (shape, logical axes, init;
`repro_torch.models.common`); a *rules* table maps logical axes to the
names of a `DeviceMesh`'s dims, and the same schema then yields

  * materialized params (`init_params`, in `models.common`),
  * abstract params (`abstract_params`: ``device="meta"`` tensors, no
    allocation), for the dry-run,
  * per-tensor DTensor placements (`tree_shardings`) and DTensors
    (`distribute`).

`spec_for` gives the port's PartitionSpec: one entry per tensor dim, a
mesh-dim name, a tuple of names or None.  `placements` turns it into one
placement per mesh dim: ``Shard(tensor_dim)`` on each mesh dim the spec
names and ``Replicate()`` on the others.  A tuple such as ("pod", "data")
shards one tensor dim over both mesh dims, the first name major, as JAX
reads it; DTensor splits a dim shard by shard in mesh-dim order, so the
tuple must name its mesh dims in that order.

The models make plain tensors (positions, masks, RoPE tables) beside
the DTensors: run them on DTensors under
``torch.distributed.tensor.experimental.implicit_replication()``, which
treats those as replicated.

Rules compose per run as in the JAX package: TP shards heads/mlp/vocab on
"model", FSDP shards the embed axis of params on "data", EP shards
"experts" on "model", SP shards long sequences on "model", and the
multi-pod mesh adds a pure-DP "pod" axis.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..models.common import P, init_params, to_dtype  # noqa: F401

Axes = Tuple[Optional[str], ...]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# Default logical→mesh rules.  None → replicated on that axis.
DEFAULT_RULES: Dict[str, Optional[Union[str, Tuple[str, ...]]]] = {
    "batch": ("pod", "data"),      # activations' batch dim
    "seq": None,                   # sequence (→ "model" under SP)
    "embed": "data",               # FSDP: shard params' embed dim on data
    "embed2": None,                # square-matrix second embed axis
    "heads": "model",              # TP
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",            # EP
    "layers": None,                # scan axis — never sharded
    "conv": None,
    "state": None,
    "window": None,                # KV-cache slots (→ "model" under SP)
    "act_embed": None,             # activations' model dim (replicated)
    "act_mlp": "model",            # activations' FFN-hidden dim (TP);
    "act_vocab": "model",          # logits' vocab dim (TP) — separate from
                                   # the weight axes so sequence
                                   # parallelism can unmap them
}


def make_rules(mesh, **overrides) -> Dict[str, Any]:
    """Rules valid for ``mesh``, a `DeviceMesh` (or anything with
    ``mesh_dim_names``): axes absent from the mesh are dropped."""
    rules = dict(DEFAULT_RULES)
    rules.update(overrides)
    names = set(mesh.mesh_dim_names)

    def fix(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            kept = tuple(x for x in v if x in names)
            return kept if kept else None
        return v if v in names else None

    return {k: fix(v) for k, v in rules.items()}


def spec_for(axes: Axes, rules: Dict[str, Any]) -> Spec:
    """The PartitionSpec of a tensor with logical ``axes``."""
    return tuple(rules.get(a) if a is not None else None for a in axes)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for tdim, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(n) for n in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} names mesh dims out of the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh dim {names[i]!r} shards two dims "
                                 f"of spec {spec}")
            out[i] = Shard(tdim)
    return tuple(out)


def _map_schema(fn, schema):
    if isinstance(schema, P):
        return fn(schema)
    return {k: _map_schema(fn, v) for k, v in schema.items()}


def tree_shardings(schema: Any, mesh, rules: Dict[str, Any]) -> Any:
    """Placement tree mirroring a schema."""
    return _map_schema(lambda p: placements(spec_for(p.axes, rules), mesh),
                       schema)


def distribute(tree: Any, schema: Any, mesh, rules: Dict[str, Any]) -> Any:
    """``tree`` (tensors in the schema's tree) as DTensors placed by the
    rules.  Each rank keeps its own shard of its own tensor: nothing is
    sent (``src_data_rank=None``), so a meta tree stays unallocated."""
    def walk(t, pl):
        if isinstance(pl, dict):
            return {k: walk(t[k], pl[k]) for k in pl}
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    return walk(tree, tree_shardings(schema, mesh, rules))


def abstract_params(schema: Any, param_dtype: str) -> Any:
    """The schema as ``device="meta"`` tensors: shapes and dtypes, no
    storage."""
    return _map_schema(
        lambda p: torch.empty(p.shape, dtype=to_dtype(p.dtype or param_dtype),
                              device="meta"), schema)


def logical_constraint(x: torch.Tensor, axes: Axes,
                       rules: Optional[Dict[str, Any]]) -> torch.Tensor:
    """Redistribute a DTensor to the placements of its logical ``axes``;
    ``x`` itself without rules or when it is not a DTensor (JAX's version
    returns ``x`` outside a mesh)."""
    if rules is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          placements(spec_for(axes, rules), x.device_mesh))
