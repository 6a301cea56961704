"""Per-device cost of one step, counted while the step runs on meta
DTensors (the port's counterpart of the JAX package's
``roofline/hlo_analysis.py``).

The JAX dry-run lowers each step to SPMD-partitioned HLO and walks it.
The port has no HLO: `count` runs the step itself, op by op, on
``device="meta"`` DTensors over a fake process group (no data, no
communication), under `CostMode`, a dispatch mode that sees every op
twice.  A DTensor op arrives first, at its global shape; the mode runs it
under a second instance of itself, which leaves the DTensor op to
DTensor's own dispatch, and DTensor then runs the redistributions and the
local op on the rank's shards, which reach that instance as plain tensors
at their local shapes.  Only those local ops are counted, so every count is per device, exact for rank 0's shards: work on a
dim that is replicated over a mesh dim counts whole on each device.  (The
ops DTensor runs at the global shape to infer its output's metadata run
under a fake-tensor mode and are skipped.)

Three quantities are recorded:

  * **flops**: ``torch.utils.flop_counter``'s formulas (matmuls,
    convolutions, attention) on the local shapes;
  * **bytes**: every non-view local op's input and output bytes, in all
    and by op (`Analysis.bytes_by_op`).  The port runs eagerly, op by
    op, so each op's operands cross HBM; this is the eager counterpart
    of the JAX walk, which charges only fusion boundaries.  The two byte
    models differ by design: an elementwise chain that XLA fuses into
    one pass counts once per op here;
  * **collectives**: the ``_c10d_functional`` ops that DTensor issues, by
    kind (JAX's names: all-gather, all-reduce, reduce-scatter,
    all-to-all), operand bytes, group size, span (rank 0's group, from
    its first rank to its last, plus one) and count.

Where DTensor has no sharding strategy for an op (forward or backward),
the mode places it explicitly: it replicates the operands over the last
mesh dim and tries again, then over the last two, and so on (a failed
attempt is not counted); where even whole replicas fail, it runs the op
on the local copies, its outputs replicated.  An op that writes an
operand copies the result back into it.  The collectives this costs are counted,
and `Analysis.replicated` names each such op with its count.  A gather
over a sharded dim is run without DTensor's masked partial, whose mask
cannot be built on meta tensors (`_sharded_gather`).  The modes are for
meta tensors: values are never looked at.

The global counts (`Analysis.global_flops`/``global_bytes``) take each
DTensor op at its global shape, and each plain op of a
`repro_torch.parallel.sharding.map_shards` body (work each rank runs on
its own shards) times the number of shards it is split into.

The mode also keeps the live bytes of the storages the local ops create;
their peak is `Analysis.peak_bytes` (activations, gradients and
temporaries; the step's arguments are not in it).
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only
from torch.utils.flop_counter import flop_registry

# the models first: the sharding module imports them, and they import it
from .. import models  # noqa: F401
from ..parallel.sharding import shard_share

aten = torch.ops.aten

# functional collective → the JAX (HLO) kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}
# ops that move no bytes: allocation, and the functional collectives'
# bookkeeping
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd",
             "lift_fresh"}
# messages of DTensor's sharding propagation when it has no strategy; the
# last is a view whose strategy gives the shards a shape they cannot take
# (a dim sharded over two mesh dims, flattened, then split again)
_NO_STRATEGY = ("Sharding propagation failed", "requires redistribution",
                "no valid strategy", "does not have a sharding strategy",
                "not supported for DTensor", "is invalid for input of size")


@dataclass
class Analysis:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_ops: List[dict] = field(default_factory=list)
    peak_bytes: int = 0
    replicated: Dict[str, int] = field(default_factory=dict)
    # the same counts for the whole program on one device: the DTensor ops
    # at their global shapes, a `map_shards` body's ops times its shards
    global_flops: float = 0.0
    global_bytes: float = 0.0
    # the local bytes by op (its overload packet's name), largest first
    bytes_by_op: Dict[str, float] = field(default_factory=dict)


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


def _tensor_bytes(tree) -> int:
    return sum(_nbytes(t) for t in tree_flatten(tree)[0])


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _group(args) -> Tuple[int, int]:
    """(size, span) of a functional collective's group: span is the
    distance from its first rank to its last, plus one."""
    pg = dist.distributed_c10d._resolve_process_group(args[-1])
    ranks = dist.get_process_group_ranks(pg)
    return len(ranks), max(ranks) - min(ranks) + 1


def _op_cost(func, args, kwargs, out) -> Tuple[float, int]:
    """(FLOPs, bytes) of one op at the shapes it is given."""
    flops = 0.0
    if func._overloadpacket in flop_registry:
        flops = float(flop_registry[func._overloadpacket](
            *args, **kwargs, out_val=out))
    if func._overloadpacket.__name__ in _NO_BYTES or _is_view(func):
        return flops, 0
    return flops, _tensor_bytes((args, kwargs)) + _tensor_bytes(out)


def _replicate(t: DTensor) -> DTensor:
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _sharded_gather(src, dim, index):
    """``aten.gather`` of a source sharded on the gathered dim, run as
    DTensor runs it but without its masked partial: each rank gathers from
    its shard, and the output is a partial sum over the mesh dims that
    shard ``dim``, reduced by one all-reduce where it is used.  None when
    ``dim`` is not sharded."""
    if not isinstance(src, DTensor):
        return None
    dim %= src.ndim
    mesh, pl = src.device_mesh, list(src.placements)
    if any(isinstance(p, Partial) for p in pl):
        # reduce-scattered onto the gathered dim, as DTensor would
        pl = [Shard(dim) if isinstance(p, Partial) else p for p in pl]
        src = src.redistribute(mesh, pl)
    on_dim = [i for i, p in enumerate(pl)
              if isinstance(p, Shard) and p.dim == dim]
    if not on_dim:
        return None
    idx_pl = [Replicate() if i in on_dim else p for i, p in enumerate(pl)]
    if not isinstance(index, DTensor):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim)
    index = index.redistribute(mesh, idx_pl)
    local = torch.gather(src.to_local(), dim, index.to_local())
    out_pl = [Partial("sum") if i in on_dim else p
              for i, p in enumerate(idx_pl)]
    return DTensor.from_local(local, mesh, out_pl, shape=index.shape,
                              stride=index.stride())


def _written(func, args):
    """The positions of the operands that ``func`` writes."""
    schema = func._schema.arguments
    return [i for i, a in enumerate(args) if isinstance(a, DTensor)
            and i < len(schema) and schema[i].alias_info is not None
            and schema[i].alias_info.is_write]


def _on_kept(func, args, kwargs, keep: int):
    """``func`` through DTensor with every operand's placements on the
    first ``keep`` mesh dims kept and the others replicated; an operand
    the op writes gets the result copied back."""
    def cut(t):
        pl = list(t.placements[:keep]) \
            + [Replicate()] * (t.device_mesh.ndim - keep)
        return t.redistribute(t.device_mesh, pl)
    r_args, r_kwargs = tree_map_only(DTensor, cut, (args, kwargs))
    out = func(*r_args, **r_kwargs)
    for i in _written(func, args):
        args[i].copy_(r_args[i])
        if out is r_args[i]:
            out = args[i]
    return out


def _on_replicas(func, args, kwargs):
    """``func`` run on whole copies: every DTensor operand is
    redistributed to ``Replicate()`` and the op runs on its local tensor
    (made contiguous for a view); the outputs are replicated DTensors, and
    an operand the op writes gets the result copied back."""
    mesh = next(t for t in tree_flatten((args, kwargs))[0]
                if isinstance(t, DTensor)).device_mesh
    rep = [Replicate()] * mesh.ndim
    local_args, local_kwargs = tree_map_only(
        DTensor, lambda t: _replicate(t).to_local(), (args, kwargs))
    if _is_view(func):
        local_args, local_kwargs = tree_map_only(
            torch.Tensor, torch.Tensor.contiguous, (local_args, local_kwargs))
    out = func(*local_args, **local_kwargs)
    for i in _written(func, args):
        args[i].copy_(DTensor.from_local(local_args[i], mesh, rep))
        if out is local_args[i]:
            return args[i]
    return tree_map_only(torch.Tensor,
                         lambda t: DTensor.from_local(t, mesh, rep), out)


class _Counts:
    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.global_flops = 0.0
        self.global_bytes = 0.0
        self.coll: Dict[Tuple[str, int, int, int], int] = defaultdict(int)
        self.by_op: Dict[str, float] = defaultdict(float)
        self.replicated: Dict[str, int] = defaultdict(int)
        self.live = 0
        self.peak = 0
        self.seen = set()

    def snapshot(self):
        return (self.flops, self.bytes, self.global_flops,
                self.global_bytes, dict(self.coll), dict(self.by_op))

    def restore(self, snap):
        (self.flops, self.bytes, self.global_flops, self.global_bytes,
         coll, by_op) = snap
        self.coll = defaultdict(int, coll)
        self.by_op = defaultdict(float, by_op)

    def track(self, out):
        """Add the storages that ``out`` brings to the live bytes; each is
        taken off when it is freed."""
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self.seen:
                continue
            n = st.nbytes()
            self.seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self.free, key, n)

    def free(self, key, n):
        self.seen.discard(key)
        self.live -= n


class CostMode(TorchDispatchMode):
    """Counts the local ops of a step on meta DTensors (module
    docstring).  The instance the caller enters takes each DTensor op and
    runs it under an inner instance, which counts."""

    def __init__(self, counts: "_Counts | None" = None):
        super().__init__()
        self.inner = counts is not None
        self.c = counts if self.inner else _Counts()

    def _dtensor_op(self, func, args, kwargs):
        with CostMode(self.c):
            if func is aten.gather.default and not kwargs:
                out = _sharded_gather(*args)
                if out is not None:
                    return out
            try:
                return func(*args, **kwargs)
            except (RuntimeError, NotImplementedError) as e:
                if not any(m in str(e) for m in _NO_STRATEGY):
                    raise
            self.c.replicated[str(func)] += 1
            mesh = next(t for t in tree_flatten((args, kwargs))[0]
                        if isinstance(t, DTensor)).device_mesh
            # keep the leading mesh dims' placements, replicate the rest,
            # one more mesh dim at a time (an attempt that fails is not
            # counted)
            for keep in range(mesh.ndim - 1, -1, -1):
                snap = self.c.snapshot()
                try:
                    return _on_kept(func, args, kwargs, keep)
                except (RuntimeError, NotImplementedError) as e:
                    if not any(m in str(e) for m in _NO_STRATEGY):
                        raise
                    self.c.restore(snap)
            return _on_replicas(func, args, kwargs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self.inner:
                return NotImplemented   # DTensor runs it on the shards
            out = self._dtensor_op(func, args, kwargs)
            flops, nbytes = _op_cost(func, args, kwargs, out)
            self.c.global_flops += flops
            self.c.global_bytes += nbytes
            return out
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) \
                or any(isinstance(t, FakeTensor)
                       for t in tree_flatten(out)[0]):
            return out              # DTensor's metadata inference
        c = self.c
        kind = _COLLECTIVES.get(func._overloadpacket.__name__)
        if kind is not None:
            c.coll[(kind, _tensor_bytes(args[0])) + _group(args)] += 1
        flops, nbytes = _op_cost(func, args, kwargs, out)
        c.flops += flops
        c.bytes += nbytes
        if nbytes:
            c.by_op[func._overloadpacket.__name__] += nbytes
        if not self.inner:
            # a plain op outside any DTensor op: whole, or one of the
            # shards of a `map_shards` body
            share = shard_share()
            c.global_flops += flops * share
            c.global_bytes += nbytes * share
        if nbytes:
            c.track(out)
        return out

    def analysis(self) -> Analysis:
        c = self.c
        return Analysis(
            flops=float(c.flops), bytes_accessed=float(c.bytes),
            collective_ops=[{"kind": k, "operand_bytes": ob,
                             "group_size": g, "span": sp, "count": n}
                            for (k, ob, g, sp), n in sorted(c.coll.items())],
            peak_bytes=int(c.peak), replicated=dict(c.replicated),
            global_flops=float(c.global_flops),
            global_bytes=float(c.global_bytes),
            bytes_by_op=dict(sorted(c.by_op.items(), key=lambda kv: -kv[1])))


def count(fn: Callable, *args) -> Tuple[Any, Analysis]:
    """Run ``fn(*args)`` under `CostMode`; returns (its output, the
    per-device `Analysis`)."""
    mode = CostMode()
    # the models make plain tensors (positions, masks, buffers) beside
    # the DTensors: they count as replicated
    with implicit_replication(), mode:
        out = fn(*args)
    return out, mode.analysis()
