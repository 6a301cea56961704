"""Batched slice-fetch strategy — the read side of the unified I/O runtime.

The scalar client dereferenced slice pointers one at a time: every extent in
a read plan became its own storage-server round.  The paper's whole pitch is
that slice pointers make *metadata* cheap; this module makes *dereferencing*
them cheap too, which is where the batching wins of the sort benchmark (§4)
actually come from:

  1. **Coalescing.**  Planned fetches are sorted by (server, backing file,
     disk offset) and runs that are adjacent — or separated by less than
     the gap threshold — collapse into a single covering retrieval.  Thanks
     to locality-aware placement (§2.7), sequential file writes land
     sequentially in one backing file, so a vectored read over N ranges
     typically needs one round per (server, backing-file) run rather than N.
     The threshold is sized by the runtime's adaptive cost model (the bytes
     one round-trip is worth) unless ``Cluster(fetch_gap_bytes=…)`` pins it.
  2. **Scatter-gather.**  Coalesced batches that share a (server, backing
     file) but sit beyond the gap threshold travel together as ONE
     ``StorageServer.retrieve_slices`` round (zero-copy ``memoryview``s,
     no gap bytes read) — the read-side mirror of the write scheduler's
     one-``create_slices``-per-group rule.  ``Cluster(scatter_gather=
     False)`` reverts to one round per coalesced run.
  3. **Fan-out.**  Batches destined for different servers are issued as
     ``IoTask``s on the shared ``IoRuntime`` pool, so a read striped over
     the cluster completes in one server's latency, not the sum.

This module only *plans* (sort + coalesce); execution, timing and the
failover walk live in ``iort``/``Cluster.fetch_slice``.  If a covering
retrieval fails mid-flight, the strategy degrades to per-extent fetches
through the full §2.9 replica-failover path, so batching never reduces
availability.

Accounting: each covering retrieval counts once in ``StorageStats``
(``slices_read``/``bytes_read``), and the caller's ``ClientStats`` records
``fetch_batches`` (rounds issued) and ``slices_coalesced`` (pointer
dereferences saved) — the measurable effectiveness of the scheduler.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

from .errors import DegradedRead, ReplicaExhausted, StorageError
from .iort import IoTask, run_with_failover
from .slicing import Extent, SlicePointer

# Historical fixed gap threshold, kept as the adaptive model's seed and as
# the value benchmarks pin for comparable paper-reproduction accounting.
# Gap bytes are fetched and discarded: a small bounded over-read is far
# cheaper than an extra round trip, exactly like a disk elevator's seek
# threshold.
DEFAULT_MAX_GAP = 32 << 10


class _FetchBatch:
    """One coalesced storage-server round: a covering range in one backing
    file plus the parts (plan slot, chosen replica pointer, source extent)
    it satisfies."""

    __slots__ = ("server_id", "backing_file", "start", "end", "parts")

    def __init__(self, server_id: int, backing_file: str, start: int,
                 end: int, parts: List[tuple]):
        self.server_id = server_id
        self.backing_file = backing_file
        self.start = start
        self.end = end
        self.parts = parts               # [(plan_idx, chunk_idx, extent, ptr)]

    @property
    def covering(self) -> SlicePointer:
        return SlicePointer(self.server_id, self.backing_file, self.start,
                            self.end - self.start)


class _SGGroup:
    """One scatter-gather round: several coalesced batches that share a
    (server, backing file) but sit too far apart to gap-coalesce.  The
    whole group is served by ONE ``retrieve_slices`` round carrying each
    batch's covering pointer — no gap bytes between batches are read."""

    __slots__ = ("server_id", "backing_file", "batches")

    def __init__(self, server_id: int, backing_file: str,
                 batches: List[_FetchBatch]):
        self.server_id = server_id
        self.backing_file = backing_file
        self.batches = batches

    @property
    def nbytes(self) -> int:
        return sum(b.end - b.start for b in self.batches)


def plan_batches(tagged: Sequence[tuple],
                 max_gap: int = DEFAULT_MAX_GAP) -> List[_FetchBatch]:
    """Group tagged fetches ``(plan_idx, chunk_idx, extent, ptr)`` into
    coalesced per-(server, backing-file) batches."""
    ordered = sorted(
        tagged, key=lambda t: (t[3].server_id, t[3].backing_file,
                               t[3].offset))
    batches: List[_FetchBatch] = []
    for item in ordered:
        ptr = item[3]
        cur = batches[-1] if batches else None
        if (cur is not None
                and cur.server_id == ptr.server_id
                and cur.backing_file == ptr.backing_file
                and ptr.offset <= cur.end + max_gap):
            cur.end = max(cur.end, ptr.offset + ptr.length)
            cur.parts.append(item)
        else:
            batches.append(_FetchBatch(ptr.server_id, ptr.backing_file,
                                       ptr.offset, ptr.offset + ptr.length,
                                       [item]))
    return batches


class SliceScheduler:
    """Read-side strategy layer over the cluster's ``IoRuntime``.

    One scheduler per cluster, shared by all clients (it is stateless).
    ``fetch_many`` is the entry point; ``WtfClient._fetch``/``_fetch_many``
    route every data-plane read through it, so scalar reads and vectored
    reads share one code path and one accounting scheme.  It owns no pool
    and no failover loop: batches execute as ``IoTask``s on the runtime,
    and degraded fetches walk replicas via ``Cluster.fetch_slice`` (the
    unified ``iort.run_with_failover`` path).
    """

    def __init__(self, cluster, runtime,
                 max_gap: Optional[int] = None):
        self.cluster = cluster
        self.runtime = runtime
        self._max_gap = max_gap          # None → adaptive via the runtime

    @property
    def max_gap(self) -> int:
        """Current coalescing threshold (pinned or adaptive)."""
        if self._max_gap is not None:
            return self._max_gap
        return self.runtime.gap_bytes()

    def close(self) -> None:
        """Back-compat: drain the shared runtime."""
        self.runtime.close()

    # -------------------------------------------------------------- fetch
    def fetch_many(self, plans: Sequence[Sequence[Extent]],
                   stats=None, block_cache=None,
                   inode_id=None) -> List[bytes]:
        """Fetch one buffer result per extent plan (``bytes`` or a
        zero-copy ``memoryview`` — callers that need ``bytes`` semantics,
        e.g. the scalar read path, materialize at their boundary).

        Each plan is an ordered extent list (as produced by
        ``_plan_range``); zero extents are materialized locally and pointer
        extents are coalesced and fetched across all plans at once.  With
        ``block_cache`` (and the owning ``inode_id``) supplied, cached
        extents are filled before batching — a fully cached read issues
        zero storage rounds — and fetched extents are inserted after.
        """
        from .blockcache import block_key

        use_cache = block_cache is not None and inode_id is not None
        chunks: List[List[Optional[bytes]]] = [
            [None] * len(plan) for plan in plans]
        tagged: List[tuple] = []
        miss_keys = {} if use_cache else None
        hits = 0
        for pi, plan in enumerate(plans):
            for ci, e in enumerate(plan):
                if e.is_zero:
                    chunks[pi][ci] = b"\x00" * e.length
                    continue
                if use_cache:
                    key = block_key(e.ptrs[0])
                    cached = block_cache.get(key)
                    if cached is not None:
                        chunks[pi][ci] = cached
                        hits += 1
                        continue
                    miss_keys[(pi, ci)] = key
                tagged.append((pi, ci, e,
                               self._pick_replica(e.ptrs, inode_id)))

        units = self._plan_units(plan_batches(tagged, self.max_gap))
        tasks = [IoTask("fetch", u.server_id, u.nbytes
                        if isinstance(u, _SGGroup) else u.end - u.start, u)
                 for u in units]
        results = self.runtime.run_tasks(tasks, self._run_unit)

        rounds = physical = 0
        for parts, n_rounds, n_bytes in results:
            rounds += n_rounds
            physical += n_bytes
            for pi, ci, data in parts:
                chunks[pi][ci] = data
                if use_cache:
                    block_cache.put(miss_keys[(pi, ci)], data, inode_id)
        if stats is not None:
            stats.add(fetch_batches=rounds,
                      slices_coalesced=len(tagged) - rounds,
                      data_bytes_read=physical)
            if use_cache:
                stats.add(block_cache_hits=hits,
                          block_cache_misses=len(tagged))
        # Single-extent plans (the common sequential case) pass the
        # buffer through unjoined — no per-plan copy.
        return [c[0] if len(c) == 1 else b"".join(c) for c in chunks]

    def fetch(self, extents: Sequence[Extent], stats=None,
              block_cache=None, inode_id=None) -> bytes:
        return self.fetch_many([extents], stats=stats,
                               block_cache=block_cache,
                               inode_id=inode_id)[0]

    # ----------------------------------------------------------- internals
    def _plan_units(self, batches: List[_FetchBatch]) -> List[Any]:
        """Fold coalesced batches into scatter-gather rounds.

        Gap coalescing (``plan_batches``) merges runs closer than the gap
        threshold; batches beyond it on the SAME (server, backing file)
        used to each cost their own round.  With ``Cluster(scatter_gather)``
        on (the default), those batches travel together as one
        ``retrieve_slices`` round instead — the read-side mirror of the
        write scheduler's one-``create_slices``-per-(group, replica) rule.
        ``plan_batches`` sorts by (server, file, offset), so same-location
        batches are adjacent here.
        """
        if not getattr(self.cluster, "scatter_gather", True) \
                or len(batches) < 2:
            return list(batches)
        units: List[Any] = []
        run: List[_FetchBatch] = []

        def flush() -> None:
            if len(run) == 1:
                units.append(run[0])
            elif run:
                units.append(_SGGroup(run[0].server_id,
                                      run[0].backing_file, list(run)))
            run.clear()

        for b in batches:
            if run and (run[0].server_id, run[0].backing_file) != \
                    (b.server_id, b.backing_file):
                flush()
            run.append(b)
        flush()
        return units

    def _run_unit(self, task: IoTask) -> tuple:
        unit = task.payload
        if isinstance(unit, _SGGroup):
            return self._run_sg(unit)
        return self._run_batch_payload(unit)

    def _run_sg(self, group: _SGGroup) -> tuple:
        """Issue one scatter-gather round; degrade to per-batch (and then
        per-extent, §2.9) retrieval when the server refuses it."""
        ptrs = [b.covering for b in group.batches]
        try:
            blobs = run_with_failover(
                self.cluster, [(group.server_id, ptrs)],
                lambda srv, ps: srv.retrieve_slices(ps))
        except StorageError:
            # The chosen server died (or cannot serve the round) between
            # planning and execution: every batch walks the normal
            # covering/per-extent failover path instead.
            parts: List[tuple] = []
            rounds = physical = 0
            for b in group.batches:
                p, r, nb = self._run_batch_payload(b)
                parts.extend(p)
                rounds += r
                physical += nb
            return (parts, rounds, physical)
        out: List[tuple] = []
        total = 0
        for b, blob in zip(group.batches, blobs):
            total += len(blob)
            for pi, ci, e, ptr in b.parts:
                lo = ptr.offset - b.start
                out.append((pi, ci, blob[lo:lo + ptr.length]))
        return (out, 1, total)

    def _pick_replica(self, ptrs: Tuple[SlicePointer, ...],
                      inode_id=None) -> SlicePointer:
        """Prefer a replica on a live server so coalescing groups fetches
        onto servers that can actually answer them — and enforce the
        read-side failure policy (§2.9 + repair plane):

        * zero live replicas → typed ``ReplicaExhausted`` now, instead of
          a doomed round followed by a generic ``StorageError``;
        * fewer live replicas than ``Cluster(min_read_replicas)`` → typed
          ``DegradedRead`` (a policy refusal: the bytes are readable, the
          redundancy floor is not met);
        * any dead replica on a replicated extent files a failed-retrieve
          repair ticket for the owning inode, so reads — not just writes —
          feed the repair plane.
        """
        cluster = self.cluster
        live = [p for p in ptrs
                if (srv := cluster.servers.get(p.server_id)) is not None
                and srv.alive]
        if len(live) < len(ptrs) and inode_id is not None and len(ptrs) > 1:
            cluster.note_failed_retrieve(inode_id)
        if not live:
            raise ReplicaExhausted(
                f"no live replica among {len(ptrs)} for this extent")
        floor = getattr(cluster, "min_read_replicas", 1)
        if len(live) < floor:
            raise DegradedRead(
                f"{len(live)} live replica(s) < min_read_replicas={floor}")
        return live[0]

    def _run_batch_payload(self, batch: _FetchBatch) -> tuple:
        """Issue one batch; returns (parts, rounds, physical_bytes)."""
        if len(batch.parts) == 1:
            pi, ci, e, ptr = batch.parts[0]
            return ([(pi, ci, self.cluster.fetch_slice(e.ptrs))], 1, e.length)
        try:
            # memoryview so the per-part carving below aliases the blob
            # instead of copying it (the covering-retrieval inversion that
            # made vectored reads slower than scalar).
            blob = memoryview(self.cluster.fetch_slice((batch.covering,)))
        except StorageError:
            # Degrade to per-extent fetches with full replica failover
            # (§2.9): the chosen replica's server died between planning and
            # execution, or the covering range spans a GC'd hole.
            out = [(pi, ci, self.cluster.fetch_slice(e.ptrs))
                   for pi, ci, e, _ in batch.parts]
            return (out, len(batch.parts),
                    sum(e.length for _, _, e, _ in batch.parts))
        out = []
        for pi, ci, e, ptr in batch.parts:
            lo = ptr.offset - batch.start
            out.append((pi, ci, blob[lo:lo + ptr.length]))
        return (out, 1, len(blob))
