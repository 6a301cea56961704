"""Transaction-scoped write-behind buffer — deferred slice stores.

PR 2's write scheduler batches the stores *within* one vectored op; this
module batches them *across* ops under one commit point.  CannyFS
(arXiv 1612.06830) and DurableFS (arXiv 1811.00757) both argue the same
bargain: inside a transaction nothing is application-visible until commit,
so there is no reason to pay a storage round per write op — record the
payloads, and make every store at the commit boundary in one scheduled pass.

Mechanics:

  * While write-behind is active, ``_data_slice``/``_data_slices`` call
    ``WriteBehindBuffer.add`` instead of ``Cluster.store_slice(s)``.  The
    buffer returns an ``Extent`` whose pointer is a ``PendingPtr`` — a
    placeholder that is duck-compatible with ``SlicePointer`` for all the
    *metadata* arithmetic (``sub``, offsets, adjacency checks) but carries
    the payload bytes instead of a storage location.  Op bodies queue these
    extents into region lists exactly as they would real ones.
  * Reads inside the same transaction observe buffered writes: the plan /
    overlay path produces pending extents wherever a buffered write is the
    visible layer, and the client's fetch engine serves them from the
    buffer's memory instead of the slice scheduler (read-your-buffered-
    writes).
  * ``flush`` runs at the commit boundary, BEFORE the metadata commit: all
    pending payloads become ``StoreRequest``s and go through ``wsched`` as
    ONE planning pass — requests from *different ops* that share a region
    placement group coalesce into covering stores
    (``ClientStats.slices_cross_op_coalesced``) and distinct regions fan
    out across the ring in parallel.  Once every slice is durable, every
    recorded ``PendingPtr`` is resolved to its real replicated pointers
    (queued commutes, op artifacts, op digests), preserving the
    slices-before-metadata invariant (§2.1) — and the §2.6 replay layer
    then reuses the recorded batch pointers verbatim, never re-storing.
  * ``clear`` (transaction abort) discards the buffer: no store was ever
    dispatched, so an aborted transaction leaves zero storage garbage.

A known, safe sharpening of §2.6 semantics: a ``yank`` inside a buffered
transaction observes *pending* pointer structure; if the transaction
replays, the re-planned (now real, possibly better-merged) extents may
digest differently and abort to the application.  That is a spurious abort
(availability), never an inconsistency.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

from .errors import WtfError
from .slicing import Extent, SlicePointer
from .wsched import StoreRequest


class _PendingSlice:
    """One deferred slice creation: payload + placement, resolved to real
    replicated pointers at flush time (``ptrs`` is None until then)."""

    __slots__ = ("data", "placement_key", "hint", "op_tag", "ptrs")

    def __init__(self, data: bytes, placement_key: Any, hint: int,
                 op_tag: Any):
        self.data = data
        self.placement_key = placement_key
        self.hint = hint
        self.op_tag = op_tag
        self.ptrs: Optional[Tuple[SlicePointer, ...]] = None


class PendingPtr:
    """Placeholder pointer into a not-yet-stored slice.

    Duck-compatible with ``SlicePointer`` for metadata arithmetic:
    ``sub`` derives sub-ranges, ``offset``/``length`` locate the bytes
    within the pending payload, and ``server_id`` is a sentinel (-1) so a
    pending pointer never compares adjacent/equal to a real one —
    ``merge_adjacent`` must not fuse pending pointers into fake
    ``SlicePointer`` arithmetic.
    """

    __slots__ = ("cell", "offset", "length")

    backing_file = "<write-behind>"
    server_id = -1                      # never a real ring member

    def __init__(self, cell: _PendingSlice, offset: int, length: int):
        self.cell = cell
        self.offset = offset
        self.length = length

    def sub(self, start: int, length: int) -> "PendingPtr":
        if start < 0 or length < 0 or start + length > self.length:
            raise ValueError(
                f"sub-slice [{start},{start + length}) out of bounds "
                f"for pending slice of length {self.length}")
        return PendingPtr(self.cell, self.offset + start, length)

    def is_adjacent(self, other) -> bool:
        return False                    # pending pointers never merge

    # ------------------------------------------------------------- payload
    def data(self) -> bytes:
        return self.cell.data[self.offset:self.offset + self.length]

    @property
    def resolved(self) -> bool:
        return self.cell.ptrs is not None

    def real_ptrs(self) -> Tuple[SlicePointer, ...]:
        """Per-replica real pointers for this sub-range (post-flush)."""
        if self.cell.ptrs is None:
            raise WtfError("pending slice pointer dereferenced before flush")
        return tuple(p.sub(self.offset, self.length) for p in self.cell.ptrs)

    def __repr__(self) -> str:
        state = "resolved" if self.resolved else "pending"
        return f"<PendingPtr {state} +{self.offset}:{self.length}>"


# ----------------------------------------------------------- extent helpers
def extent_is_pending(e: Extent) -> bool:
    return any(isinstance(p, PendingPtr) for p in e.ptrs)


def extent_is_resolved(e: Extent) -> bool:
    return all(p.resolved for p in e.ptrs if isinstance(p, PendingPtr))


def pending_extent_bytes(e: Extent) -> bytes:
    """Serve a pending extent's bytes straight from the buffered payload."""
    for p in e.ptrs:
        if isinstance(p, PendingPtr):
            return p.data()
    raise WtfError("extent has no pending pointer")


def resolve_extent(e: Extent) -> Extent:
    """Swap every pending pointer for its real replicated pointers."""
    if not extent_is_pending(e):
        return e
    ptrs: List[SlicePointer] = []
    for p in e.ptrs:
        if isinstance(p, PendingPtr):
            ptrs.extend(p.real_ptrs())
        else:
            ptrs.append(p)
    return Extent(e.offset, e.length, tuple(ptrs))


def resolve_value(v: Any) -> Any:
    """Recursively resolve pending extents inside op artifacts/digests."""
    if isinstance(v, Extent):
        return resolve_extent(v)
    if isinstance(v, tuple):
        return tuple(resolve_value(x) for x in v)
    if isinstance(v, list):
        return [resolve_value(x) for x in v]
    if isinstance(v, dict):
        return {k: resolve_value(x) for k, x in v.items()}
    return v


class WriteBehindBuffer:
    """Per-client accumulator of deferred stores (one commit scope at a
    time: either the open ``WtfTransaction`` or the current auto-commit op,
    matching the client's not-thread-safe contract)."""

    __slots__ = ("_slices", "_live")

    def __init__(self):
        self._slices: List[_PendingSlice] = []
        self._live: set = set()          # id(cell) of every live cell

    @property
    def pending(self) -> bool:
        return bool(self._slices)

    def __len__(self) -> int:
        return len(self._slices)

    def add(self, placement_key: Any, hint: int, data: bytes,
            op_tag: Any) -> Extent:
        """Record one deferred slice; returns the placeholder extent the op
        body queues into region metadata."""
        cell = _PendingSlice(bytes(data), placement_key, hint, op_tag)
        self._slices.append(cell)
        self._live.add(id(cell))
        return Extent(0, len(cell.data), (PendingPtr(cell, 0,
                                                     len(cell.data)),))

    def owns(self, e: Extent) -> bool:
        """True iff every unresolved pending pointer in ``e`` references a
        cell of THIS buffer's current commit scope — a dead pointer from an
        aborted scope must be rejected at the call site, not at flush."""
        return all(id(p.cell) in self._live for p in e.ptrs
                   if isinstance(p, PendingPtr) and not p.resolved)

    def flush(self, cluster, stats=None) -> int:
        """Store every pending payload through the write scheduler as ONE
        planning pass and resolve the cells.  All data is durable before
        this returns; the caller then rewrites queued metadata with the
        real pointers and commits (§2.1 order).  Raises ``StorageError``
        if any slice achieved zero replicas — the commit must not proceed.
        """
        if not self._slices:
            return 0
        requests = [StoreRequest(i, c.data, c.placement_key, c.hint,
                                 op_tag=c.op_tag)
                    for i, c in enumerate(self._slices)]
        ptrs = cluster.store_slices(requests, stats=stats)
        for i, cell in enumerate(self._slices):
            cell.ptrs = ptrs[i]
        n = len(self._slices)
        if stats is not None:
            stats.add(writeback_flushes=1)
        # Cells stay alive through any PendingPtr the application still
        # holds (e.g. yanked extents); the buffer itself is spent.
        self._slices = []
        self._live = set()
        return n

    def clear(self) -> None:
        """Abort path: drop the pending payloads.  Nothing was ever sent to
        a storage server, so there is no garbage to reclaim."""
        self._slices = []
        self._live = set()
