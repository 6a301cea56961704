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

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.utils._pytree import tree_flatten, tree_unflatten

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


def shard_dims(x: DTensor, tdim: int) -> list:
    """The mesh dims that shard tensor dim ``tdim`` of ``x``."""
    tdim %= x.ndim
    return [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == tdim]


def redistribute(x: torch.Tensor, pl) -> torch.Tensor:
    """``x`` with placements ``pl`` (one per mesh dim); ``x`` itself when
    it is not a DTensor or already placed so."""
    if not isinstance(x, DTensor) or tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(x.device_mesh, tuple(pl))


def weight_for(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The weight ``w`` of ``x @ w``.  Under sequence parallelism (a dim
    of ``x`` between the batch and the last is sharded) it is gathered
    over every mesh dim that shards the rows of ``x``, as the JAX
    partitioner gathers FSDP and tensor-parallel weights there: DTensor
    would keep the weight sharded and move the activations, which are far
    larger.  Otherwise the choice is left to DTensor, which moves the
    smaller side (the tokens of a decode step, the weight shards of a
    batch-sharded step).  ``w`` itself when either is not a DTensor."""
    if not isinstance(x, DTensor) or not isinstance(w, DTensor):
        return w
    last = x.ndim - 1
    rows = [isinstance(p, Shard) and p.dim < last for p in x.placements]
    if not any(isinstance(p, Shard) and 0 < p.dim < last
               for p in x.placements):
        return w
    return redistribute(w, [Replicate() if r else wp
                            for r, wp in zip(rows, w.placements)])


def whole_on(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with its dim ``dim`` whole on every rank (replicated over the
    mesh dims that shard it; its other placements kept)."""
    if not isinstance(x, DTensor):
        return x
    split = shard_dims(x, dim)
    return redistribute(x, [Replicate() if i in split else p
                            for i, p in enumerate(x.placements)])


def last_row(x: torch.Tensor) -> torch.Tensor:
    """``x[:, -1]``.  Where a DTensor's dim 1 is sharded, DTensor would
    gather all of ``x`` to take one row; here each rank sums its rows
    masked to the last (a partial sum that only the rank holding it adds
    to), so one [B, ...] row is reduced instead."""
    if not isinstance(x, DTensor) or not shard_dims(x, 1):
        return x[:, -1]
    onehot = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
    onehot[-1] = 1
    return (x * onehot.view((-1,) + (1,) * (x.ndim - 2))).sum(dim=1)


_SHARES = [1]


def shard_share() -> int:
    """The number of shards the work running now is split into: 1
    outside `map_shards`; inside, the product of the sizes of the mesh
    dims that shard its operands (the dry-run's counter scales a plain
    op's cost by it to get the op's global cost)."""
    return _SHARES[-1]


def map_shards(fn, args, in_pl, out_pl, out_shapes=None):
    """``fn(*args)`` run on each rank's shards as plain tensors, for work
    that is independent along every sharded dim (a recurrence over time
    per sequence and head, attention per query block and head):
    dispatched op by op through DTensor, each step of such a loop would
    gather what it slices, and each op would search DTensor's strategies.

    ``args[i]`` is redistributed to the placements ``in_pl[i]`` (None:
    passed as it is) and handed to ``fn`` as its local shard.  The output
    tensors (a tensor or a tuple, nested or not) come back as DTensors
    placed by ``out_pl``, one entry per output tensor in flattened order.
    ``out_shapes`` gives their global shapes in the same order, for
    outputs whose sharded dims need not split evenly (by default each
    global shape is the local one times the mesh dims that shard it).
    The gradient of an input replicated over a mesh dim that shards an
    output is a partial sum over it.  With no DTensor among ``args``, this
    is ``fn(*args)``."""
    lead = next((a for a in args if isinstance(a, DTensor)), None)
    if lead is None:
        return fn(*args)
    mesh = lead.device_mesh
    split = {i for pl in out_pl for i, p in enumerate(pl)
             if isinstance(p, Shard)}
    share = math.prod(mesh.size(i) for i in split | {
        i for pl in in_pl if pl is not None for i, p in enumerate(pl)
        if isinstance(p, Shard)})

    def local(a, pl):
        if pl is None or not isinstance(a, DTensor):
            return a
        grad_pl = [Partial() if i in split and isinstance(p, Replicate)
                   else p for i, p in enumerate(pl)]
        return redistribute(a, pl).to_local(grad_placements=grad_pl)

    _SHARES.append(share)
    try:
        leaves, spec = tree_flatten(fn(*(local(a, pl) for a, pl
                                         in zip(args, in_pl))))
    finally:
        _SHARES.pop()
    pls = iter(out_pl)
    shapes = iter(out_shapes or [None] * len(out_pl))

    def placed(t):
        shape = next(shapes)
        stride = None if shape is None else \
            torch.empty(shape, device="meta").stride()
        return DTensor.from_local(t, mesh, tuple(next(pls)), run_check=False,
                                  shape=shape, stride=stride)
    return tree_unflatten([placed(t) if isinstance(t, torch.Tensor) else t
                           for t in leaves], spec)


def map_shards_by_axes(fn, args, in_axes, out_axes, rules):
    """`map_shards` with placements given as logical axes (None: an
    argument passed as it is); give the sequence dim None, so that each
    rank holds the whole of it.  Without rules this is ``fn(*args)``."""
    lead = next((a for a in args if isinstance(a, DTensor)), None)
    if rules is None or lead is None:
        return fn(*args)
    mesh = lead.device_mesh

    def pl(axes):
        return None if axes is None else placements(spec_for(axes, rules),
                                                    mesh)
    return map_shards(fn, args, [pl(a) for a in in_axes],
                     [pl(a) for a in out_axes])


def logical_constraint(x: torch.Tensor, axes: Axes,
                       rules: Optional[Dict[str, Any]]) -> torch.Tensor:
    """Redistribute a DTensor to the placements of its logical ``axes``,
    its gradient too (`_Constrain`); ``x`` itself without rules or when it
    is not a DTensor (JAX's version returns ``x`` outside a mesh)."""
    if rules is None or not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, placements(spec_for(axes, rules),
                                          x.device_mesh))


class _Constrain(torch.autograd.Function):
    """A redistribution whose gradient is held to the same placements, as
    JAX's sharding constraint holds the cotangent to its sharding.
    DTensor's own `redistribute` leaves the gradient as the op before it
    made it: a partial sum, which the next product may then keep partial
    by computing whole on every rank instead of reducing it first."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return redistribute(x, pl)

    @staticmethod
    def backward(ctx, grad):
        grad = redistribute(grad, ctx.pl)
        if isinstance(grad, DTensor) and \
                not grad.to_local().is_contiguous():
            # a gathered or re-split shard can come back strided, and the
            # view in the next op's backward needs it dense
            grad = DTensor.from_local(grad.to_local().contiguous(),
                                      grad.device_mesh, grad.placements,
                                      shape=grad.shape, stride=grad.stride())
        return grad, None
