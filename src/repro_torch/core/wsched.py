"""Write-path store strategy — the write side of the unified I/O runtime.

PR 1 made the read path batched and scheduled (``iosched``); this module is
its write-side mirror.  The scalar client pays one synchronous
``Cluster.store_slice`` round per slice, serially per replica.  Here a
vectored op *plans* all its stores first (``StoreRequest``), and the
strategy then:

  1. **Groups by target.**  Requests are grouped by (replica-candidate
     servers, backing-file hint) — the placement ring (§2.7) maps a
     metadata region to one server and one backing file, so all writes for
     a region share a group and land sequentially on one disk.
  2. **Coalesces.**  Within a group, runs of small requests (each at most
     the pack threshold — sized by the runtime's adaptive cost model, or
     pinned by ``Cluster(store_coalesce_bytes=…)``) are packed into a
     single covering store; per-request pointers are carved back out with
     ``SlicePointer.sub`` arithmetic.  The remaining units still travel in
     ONE ``create_slices`` round per server — parts are appended
     contiguously under one backing-file lock.
  3. **Fans out.**  Replica creations for *distinct* servers (and groups
     targeting different servers) are issued as ``IoTask``s on the shared
     ``IoRuntime`` pool, so a multi-region write completes in one server's
     latency, not the sum, and replication costs max — not sum — of the
     replica round trips.

Failure handling (§2.9): each (group, replica) task walks the ring owners
through the unified ``iort.run_with_failover`` loop; a ``StorageError``
marks the server failed and falls back to the next owner, never reusing a
server another replica of the same data already landed on.  A store that
achieves at least one but fewer than ``replication`` replicas is recorded
as *degraded* (never silent); zero replicas raises ``StorageError``.

Accounting: ``ClientStats.store_batches`` counts server store rounds
actually issued and ``slices_store_coalesced`` counts the logical stores
folded into those rounds — the measurable effectiveness of the scheduler.
Server-side, each round bumps ``StorageStats.slices_created`` once and
``slices_written`` per logical slice carried.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .errors import StorageError
from .iort import IoTask, run_with_failover
from .slicing import SlicePointer

# Historical fixed pack threshold, kept as the adaptive model's seed and as
# the value benchmarks pin for comparable accounting.  A covering store of
# small writes costs nothing extra, while large writes keep their own
# pointers so GC and compaction see them individually.
DEFAULT_MAX_COALESCE = 32 << 10


class StoreRequest:
    """One planned slice creation: ``data`` placed for ``placement_key``
    (ring lookup) with ``hint`` (server-local backing-file lookup).  ``key``
    identifies the request in the result map.  ``op_tag``, when set, names
    the logged op that planned the request — the write-behind buffer tags
    each pending store so cross-op coalescing is measurable
    (``ClientStats.slices_cross_op_coalesced``)."""

    __slots__ = ("key", "data", "placement_key", "hint", "op_tag")

    def __init__(self, key: Any, data: bytes, placement_key: Any, hint: int,
                 op_tag: Any = None):
        self.key = key
        self.data = data
        self.placement_key = placement_key
        self.hint = hint
        self.op_tag = op_tag


class _Unit:
    """One part of a ``create_slices`` round: either a single large request
    or a covering pack of small adjacent ones.  ``spans`` maps each packed
    request to its byte range within the unit."""

    __slots__ = ("data", "spans")

    def __init__(self, data: bytes, spans: List[Tuple[StoreRequest, int, int]]):
        self.data = data
        self.spans = spans


class _StoreGroup:
    """All requests bound for one (replica candidate list, backing file).

    Owns the replica-placement state shared by this group's per-replica
    tasks: ``used`` servers (replicas must stay distinct, §2.9) guarded by
    ``lock`` because the tasks run concurrently on the pool.
    """

    __slots__ = ("candidates", "hint", "requests", "units", "used", "lock")

    def __init__(self, candidates: Tuple[int, ...], hint: int):
        self.candidates = candidates
        self.hint = hint
        self.requests: List[StoreRequest] = []
        self.units: List[_Unit] = []
        self.used: set[int] = set()
        self.lock = threading.Lock()

    def pack(self, max_coalesce: int) -> None:
        """Pack runs of small requests into covering units (plan order is
        preserved, so carved pointers stay disk-adjacent in file order)."""
        run: List[StoreRequest] = []

        def flush() -> None:
            if not run:
                return
            off, spans = 0, []
            for r in run:
                spans.append((r, off, len(r.data)))
                off += len(r.data)
            self.units.append(_Unit(b"".join(r.data for r in run),
                                    list(spans)))
            run.clear()

        for r in self.requests:
            if len(r.data) > max_coalesce:
                flush()
                self.units.append(_Unit(r.data, [(r, 0, len(r.data))]))
            else:
                run.append(r)
        flush()


def plan_store_groups(requests: Sequence[StoreRequest], ring, n_servers: int,
                      max_coalesce: int = DEFAULT_MAX_COALESCE
                      ) -> List[_StoreGroup]:
    """Group planned stores by (replica candidates, hint) and pack each
    group's small runs into covering units."""
    groups: Dict[Tuple[Tuple[int, ...], int], _StoreGroup] = {}
    for r in requests:
        cands = tuple(ring.owners(r.placement_key, n_servers))
        g = groups.get((cands, r.hint))
        if g is None:
            g = groups[(cands, r.hint)] = _StoreGroup(cands, r.hint)
        g.requests.append(r)
    out = list(groups.values())
    for g in out:
        g.pack(max_coalesce)
    return out


class WriteScheduler:
    """Write-side strategy layer over the cluster's ``IoRuntime``.

    One scheduler per cluster, shared by all clients; it owns no pool and
    no failover loop of its own.  ``store_many`` is the entry point; the
    client's ``_data_slices`` routes every vectored write through it so
    batched and scalar stores share one accounting scheme.
    """

    def __init__(self, cluster, runtime,
                 max_coalesce: Optional[int] = None):
        self.cluster = cluster
        self.runtime = runtime
        self._max_coalesce = max_coalesce    # None → adaptive via runtime

    @property
    def max_coalesce(self) -> int:
        """Current packing threshold (pinned or adaptive)."""
        if self._max_coalesce is not None:
            return self._max_coalesce
        return self.runtime.coalesce_bytes()

    # -------------------------------------------------------------- store
    def store_many(self, requests: Sequence[StoreRequest],
                   stats=None) -> Dict[Any, Tuple[SlicePointer, ...]]:
        """Store every request with ``cluster.replication`` replicas.

        Returns ``{request.key: (ptr per replica, ...)}``.  All data is
        durable on every returned pointer's server before this returns —
        metadata queued afterwards preserves the §2.1 invariant for the
        whole batch.
        """
        if not requests:
            return {}
        cluster = self.cluster
        want = max(1, cluster.replication)
        groups = plan_store_groups(requests, cluster._ring,
                                   len(cluster.servers), self.max_coalesce)
        # Cross-op coalescing: requests packed into one covering unit whose
        # op tag differs from the unit's first request came from *another*
        # logged op — the win the write-behind buffer exists for.  Counted
        # once per unit at plan time (replica rounds reuse the same packing).
        cross_op = 0
        for g in groups:
            for unit in g.units:
                if len(unit.spans) > 1:
                    first = unit.spans[0][0].op_tag
                    cross_op += sum(
                        1 for r, _, _ in unit.spans[1:]
                        if r.op_tag is not None and r.op_tag != first)
        tasks = [IoTask("store", g.candidates[rank % len(g.candidates)],
                        sum(len(u.data) for u in g.units), (g, rank))
                 for g in groups for rank in range(want)]
        results = self.runtime.run_tasks(tasks, self._run_replica)

        # Collate per-replica pointer lists back into per-request tuples.
        by_group: Dict[int, List[Optional[List[SlicePointer]]]] = {}
        rounds = physical = coalesced = 0
        for task, res in zip(tasks, results):
            g, rank = task.payload
            by_group.setdefault(id(g), []).append(res)
            if res is not None:
                rounds += 1
                physical += sum(len(r.data) for r in g.requests)
                coalesced += len(g.requests) - 1
        out: Dict[Any, Tuple[SlicePointer, ...]] = {}
        degraded = 0
        for g in groups:
            replicas = [r for r in by_group[id(g)] if r is not None]
            if not replicas:
                raise StorageError(
                    "no storage server could accept the slice batch")
            short = len(replicas) < want
            if short:
                # per-request unit, matching the scalar pipeline: every
                # slice in the short group is under-replicated
                degraded += len(g.requests)
            for i, req in enumerate(g.requests):
                out[req.key] = tuple(rep[i] for rep in replicas)
                if short:
                    # File a repair ticket per short request: the placement
                    # key names the (inode, region), which is everything
                    # the repair plane needs to re-replicate it later.
                    cluster.enqueue_repair(req.placement_key,
                                           ptrs=out[req.key])
        if degraded:
            cluster.note_degraded_stores(degraded)
            if getattr(cluster, "strict_replication", False):
                raise StorageError(
                    f"strict_replication: {degraded} slice(s) achieved "
                    f"fewer than {want} replicas")
        if stats is not None:
            stats.add(store_batches=rounds,
                      slices_store_coalesced=coalesced,
                      slices_cross_op_coalesced=cross_op,
                      data_bytes_written=physical,
                      degraded_stores=degraded)
        return out

    # ----------------------------------------------------------- internals
    def _run_replica(self, task: IoTask) -> Optional[List[SlicePointer]]:
        """One (group, replica) store round via the unified failover walk.

        Candidates are the group's ring owners rotated to this replica's
        preferred rank; a server already holding a replica of this group is
        never reused (claimed under the group lock), a ``StorageError``
        releases the claim, marks the server failed (§2.9) and falls back
        to the next owner.  Returns per-request pointers, or ``None`` if
        every candidate refused (the caller decides degraded vs. fatal).
        """
        g, rank = task.payload
        n = len(g.candidates)

        def candidates():
            for i in range(n):
                sid = g.candidates[(rank + i) % n]
                with g.lock:
                    if sid in g.used:
                        continue
                    srv = self.cluster.servers.get(sid)
                    if srv is None or not srv.alive:
                        continue
                    g.used.add(sid)
                yield sid, sid

        def attempt(srv, sid):
            task.server_id = sid        # actual target, for the cost model
            ptrs = srv.create_slices([u.data for u in g.units], g.hint)
            out: List[SlicePointer] = []
            for unit, uptr in zip(g.units, ptrs):
                for req, start, length in unit.spans:
                    out.append(uptr.sub(start, length))
            return out

        def release(sid):
            with g.lock:
                g.used.discard(sid)

        return run_with_failover(self.cluster, candidates(), attempt,
                                 release=release,
                                 exhausted=lambda _last: None)
