"""Background repair plane: re-replication after server loss (§2.9 healing).

Before this module the crash story stopped at *degrade*: a failed server
left every extent it hosted under-replicated forever, ``degraded_stores``
counted the damage, and nothing healed it.  This module closes the
crash → detect → degrade → **repair** loop:

  * **Tickets, not scans, find the damage.**  Every degrade site (a store
    that achieved fewer than ``replication`` replicas, a read that failed
    over past a dead replica) enqueues a :class:`RepairTicket` naming the
    affected ``(inode, region)`` — the identity was always in the
    placement key (``placement.region_placement_key``), it just used to be
    thrown away.  The queue dedups by region, so a hot region under a
    write storm costs one ticket, and the daemon never needs a full
    metadata walk to find fresh damage.
  * **A periodic under-replication scan backstops the tickets.**  Walking
    region metadata shard-by-shard exactly like ``gc.GarbageCollector``
    does, the scan catches damage that predates the queue (a server that
    died silently between workloads) and re-verifies after repair.
  * **Repair is a normal commuting commit.**  For each under-replicated
    extent the daemon fetches the bytes from a surviving replica,
    re-replicates onto ring successors via ``create_slices`` (same
    placement key and locality hint the original writer used), and commits
    the new replica set through :class:`inode.ReplaceExtentPtrs` — no read
    dependency, so repair NEVER aborts a concurrent appender, and entries
    that changed under the scan are simply left for the next pass.
  * **Pointer canonicalization stays stable where it can.**  Surviving
    replicas keep their order, so when replica 0 survived the canonical
    first pointer — the PR 9 ``BlockCache`` key — is unchanged and hot
    cached blocks stay addressable.  When replica 0 is the casualty the
    canonical pointer must change; the daemon then drops the inode from
    the cluster-shared plan/block caches (per-client plan caches are
    version-validated and the ``ReplaceExtentPtrs`` version bump already
    invalidates them; per-client block caches keyed on the dead pointer
    only ever serve the immutable bytes that pointer named, so they stay
    correct and merely age out).

The daemon is deliberately a *client* of the existing machinery: it walks
metadata through ordinary transactions, stores through the ordinary
server API, and observes the create→commit GC shield (``release_slices``)
exactly like ``gc.compact_region`` does.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .errors import KVConflict, PreconditionFailed, StorageError
from .inode import RegionData, ReplaceExtentPtrs, region_key
from .iort import AtomicStatsMixin
from .placement import region_placement_key, stable_hash
from .slicing import SlicePointer
from .testing import witness_lock


@dataclass(frozen=True, slots=True)
class RepairTicket:
    """One unit of suspected damage.

    ``region_idx=None`` means "every region of this inode" (a failed
    retrieve knows the inode but not which region the extent came from).
    ``ptrs`` is advisory — the replica set observed at degrade time; repair
    always re-reads the authoritative region metadata before acting.
    """

    inode_id: int
    region_idx: Optional[int] = None
    ptrs: Optional[Tuple[SlicePointer, ...]] = None
    reason: str = "degraded-store"


def ticket_from_placement(placement_key: Any,
                          ptrs: Optional[Sequence[SlicePointer]] = None,
                          reason: str = "degraded-store"
                          ) -> Optional[RepairTicket]:
    """Parse a store-path placement key into a ticket.

    Region writes (``("region", inode, idx)``) and GC spills
    (``("gc-spill", inode, idx)``) both carry the (inode, region) identity;
    anything else (fixture keys in tests) yields ``None`` and the periodic
    scan remains the safety net.
    """
    if (isinstance(placement_key, tuple) and len(placement_key) == 3
            and placement_key[0] in ("region", "gc-spill")):
        return RepairTicket(inode_id=placement_key[1],
                            region_idx=placement_key[2],
                            ptrs=tuple(ptrs) if ptrs else None,
                            reason=reason)
    return None


@dataclass(slots=True)
class RepairStats(AtomicStatsMixin):
    """Repair-plane accounting (surfaced via ``Cluster.total_stats()``)."""

    tickets_enqueued: int = 0        # tickets accepted into the queue
    tickets_deduped: int = 0         # tickets folded into a queued one
    tickets_unparsed: int = 0        # degrade sites with no (inode, region)
    tickets_processed: int = 0       # tickets consumed by repair passes
    scan_passes: int = 0             # full under-replication scans run
    regions_examined: int = 0
    extents_repaired: int = 0        # entries whose replica set was healed
    replicas_created: int = 0        # fresh replica slices stored
    bytes_recopied: int = 0          # bytes fetched + re-stored for repair
    unrepairable: int = 0            # visible extents with zero live copies
    repair_conflicts: int = 0        # commits lost to a concurrent writer
    cache_drops: int = 0             # inode evictions (canonical ptr moved)
    _stats_lock: threading.Lock = field(default_factory=threading.Lock,
                                        repr=False, compare=False)


class RepairQueue:
    """Deduplicating ticket intake between the degrade sites and the daemon.

    Thread-safe: stores degrade on runtime pool threads while the daemon
    drains on its own.  Guarded by the ``repair.queue`` lock (ranked
    outermost in ``analysis.lockspec``); ``drain`` copies tickets out and
    releases before the caller touches any metadata or storage lock.
    """

    def __init__(self, stats: Optional[RepairStats] = None):
        self._lock = witness_lock(threading.Lock(), "repair.queue")
        self._pending: "Dict[tuple, RepairTicket]" = {}
        self.stats = stats if stats is not None else RepairStats()

    def put(self, ticket: RepairTicket) -> None:
        key = (ticket.inode_id, ticket.region_idx)
        with self._lock:
            known = key in self._pending \
                or (ticket.inode_id, None) in self._pending
            if not known:
                self._pending[key] = ticket
        if known:
            self.stats.add(tickets_deduped=1)
        else:
            self.stats.add(tickets_enqueued=1)

    def put_from_placement(self, placement_key: Any,
                           ptrs: Optional[Sequence[SlicePointer]] = None,
                           reason: str = "degraded-store") -> None:
        ticket = ticket_from_placement(placement_key, ptrs, reason)
        if ticket is None:
            self.stats.add(tickets_unparsed=1)
        else:
            self.put(ticket)

    def drain(self) -> List[RepairTicket]:
        with self._lock:
            tickets = list(self._pending.values())
            self._pending.clear()
        return tickets

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)


def _subtract_interval(spans: List[Tuple[int, int]],
                       lo: int, hi: int) -> List[Tuple[int, int]]:
    """Remove [lo, hi) from a sorted disjoint span list."""
    out: List[Tuple[int, int]] = []
    for a, b in spans:
        if b <= lo or a >= hi:
            out.append((a, b))
            continue
        if a < lo:
            out.append((a, lo))
        if b > hi:
            out.append((hi, b))
    return out


class RepairDaemon:
    """Consumes repair tickets and runs under-replication scans.

    Usable synchronously (``repair_pass`` / ``scan`` / ``verify`` from
    tests and benchmarks) or as a background thread (``start``/``stop``,
    registered with the cluster so an idempotent ``Cluster.close`` tears
    it down).  One daemon per cluster is the intended shape; nothing
    breaks with more, they just race to fix the same damage (commutes make
    the race benign — the loser's swap is a no-op merge).
    """

    def __init__(self, cluster, scan_every: int = 20):
        self.cluster = cluster
        self.queue: RepairQueue = cluster.repair_queue
        self.stats: RepairStats = cluster.repair_stats
        self._scan_every = max(1, scan_every)
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self, interval_s: float = 0.05) -> "RepairDaemon":
        """Run repair passes every ``interval_s`` (a full scan every
        ``scan_every``-th pass) until ``stop()`` or cluster close."""
        if self._thread is not None:
            return self
        self._stop_evt.clear()

        def loop() -> None:
            ticks = 0
            while not self._stop_evt.wait(interval_s):
                ticks += 1
                self.repair_pass(full_scan=(ticks % self._scan_every == 0))

        self._thread = threading.Thread(target=loop, name="wtf-repair",
                                        daemon=True)
        self.cluster._repair_daemon = self
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None

    # -------------------------------------------------------------- passes
    def repair_pass(self, full_scan: bool = False) -> dict:
        """Drain the ticket queue (optionally walking everything instead)
        and repair each named region.  Returns a pass summary."""
        summary = {"tickets": 0, "regions": 0, "repaired": 0,
                   "replicas_created": 0, "unrepairable": 0}
        if full_scan:
            drained = self.queue.drain()       # the walk covers them all
            if drained:
                self.stats.add(tickets_processed=len(drained))
            self.stats.add(scan_passes=1)
            targets = list(self._walk_regions())
        else:
            tickets = self.queue.drain()
            if not tickets:
                return summary
            self.stats.add(tickets_processed=len(tickets))
            summary["tickets"] = len(tickets)
            targets = []
            seen = set()
            for t in tickets:
                if t.region_idx is not None:
                    if (t.inode_id, t.region_idx) not in seen:
                        seen.add((t.inode_id, t.region_idx))
                        targets.append((t.inode_id, t.region_idx))
                else:
                    for key in self._walk_regions():
                        if key[0] == t.inode_id and key not in seen:
                            seen.add(key)
                            targets.append(key)
        for inode_id, region_idx in targets:
            r = self._repair_region(inode_id, region_idx)
            summary["regions"] += 1
            summary["repaired"] += r["repaired"]
            summary["replicas_created"] += r["replicas_created"]
            summary["unrepairable"] += r["unrepairable"]
        return summary

    def verify(self) -> dict:
        """Post-repair audit: walk every region and report replication of
        each *visible* extent against the achievable target
        (min(replication, live servers)).  ``replication_restored`` is the
        benchmark's acceptance bit."""
        cluster = self.cluster
        target = min(cluster.replication, self._n_live_servers())
        extents = under = lost = 0
        for inode_id, region_idx in self._walk_regions():
            rd = cluster.kv.get("regions", region_key(inode_id, region_idx))
            if rd is None:
                continue
            for e, visible in self._entries_with_visibility(rd):
                if not visible:
                    continue
                extents += 1
                live = sum(1 for p in e.ptrs if self._is_live(p.server_id))
                if live < target:
                    under += 1
                if live == 0:
                    lost += 1
        return {"extents": extents, "under_replicated": under,
                "lost": lost, "target_replication": target,
                "replication_restored": under == 0}

    # ----------------------------------------------------------- internals
    def _walk_regions(self):
        """Shard-by-shard region walk, same shape as ``gc._walk_keys``."""
        kv = self.cluster.kv
        shards = getattr(kv, "shards", None)
        if shards is None:
            yield from kv.keys("regions")
            return
        for shard in shards:
            yield from shard.keys("regions")

    def _is_live(self, server_id: int) -> bool:
        srv = self.cluster.servers.get(server_id)
        return srv is not None and srv.alive

    def _n_live_servers(self) -> int:
        return sum(1 for s in self.cluster.servers.values() if s.alive)

    def _entries_with_visibility(self, rd: RegionData):
        """Yield ``(extent, contributes_visible_bytes)`` for the region's
        raw overlay list (and the tier-2 indirect extent, obscured by every
        listed entry).  Later entries obscure earlier ones, so visibility
        is what's left after subtracting every *later* entry's range."""
        entries = list(rd.entries)
        layers = ([rd.indirect] if rd.indirect is not None else []) + entries
        for i, e in enumerate(layers):
            spans = [(e.offset, e.offset + e.length)]
            for later in layers[i + 1:]:
                spans = _subtract_interval(spans, later.offset,
                                           later.offset + later.length)
                if not spans:
                    break
            yield e, bool(spans)

    def _repair_region(self, inode_id: int, region_idx: int) -> dict:
        """Heal one region: re-replicate under-replicated extents and
        commit the swapped replica sets as ONE commuting op."""
        cluster = self.cluster
        out = {"repaired": 0, "replicas_created": 0, "unrepairable": 0}
        want = min(cluster.replication, self._n_live_servers())
        if want < 1:
            return out
        self.stats.add(regions_examined=1)
        kv = cluster.kv
        txn = kv.begin()
        rd: Optional[RegionData] = txn.peek("regions",
                                            region_key(inode_id, region_idx))
        if rd is None:
            txn.abort()
            return out
        pk = region_placement_key(inode_id, region_idx)
        hint = stable_hash(pk)
        mapping: Dict[Tuple[SlicePointer, ...],
                      Tuple[SlicePointer, ...]] = {}
        created: List[SlicePointer] = []
        canonical_moved = False
        recopied = 0
        for e, visible in self._entries_with_visibility(rd):
            if e.length == 0 or not e.ptrs:
                continue
            live = [p for p in e.ptrs if self._is_live(p.server_id)]
            if len(live) >= want:
                continue
            if not live:
                if visible:
                    out["unrepairable"] += 1
                    self.stats.add(unrepairable=1)
                continue
            try:
                data = bytes(cluster.fetch_slice(tuple(live)))
            except StorageError:
                out["unrepairable"] += 1 if visible else 0
                continue
            hosting = {p.server_id for p in live}
            new_ptrs: List[SlicePointer] = []
            for sid in cluster._ring.owners(pk, len(cluster.servers)):
                if len(live) + len(new_ptrs) >= want:
                    break
                if sid in hosting or not self._is_live(sid) \
                        or not cluster.health.allow(sid):
                    continue
                try:
                    ptr = cluster.servers[sid].create_slices(
                        [data], hint)[0]
                except StorageError:
                    cluster.health.record_failure(sid)
                    continue
                cluster.health.record_success(sid, 0.0)
                hosting.add(sid)
                new_ptrs.append(ptr)
            if not new_ptrs:
                continue
            # Surviving replicas keep their order: the canonical first
            # pointer (the block-cache key) is stable iff replica 0 lived.
            mapping[e.ptrs] = tuple(live) + tuple(new_ptrs)
            if live[0] != e.ptrs[0]:
                canonical_moved = True
            created.extend(new_ptrs)
            recopied += len(data) * len(new_ptrs)
            out["repaired"] += 1
            out["replicas_created"] += len(new_ptrs)
        if not mapping:
            txn.abort()
            return out
        txn.commute("regions", region_key(inode_id, region_idx),
                    ReplaceExtentPtrs(mapping))
        try:
            try:
                txn.commit()
            finally:
                # Release the create→commit GC shield on the fresh
                # replicas: published by the commit, or plain garbage.
                cluster.release_slices(created)
        except (KVConflict, PreconditionFailed):
            self.stats.add(repair_conflicts=1)
            return {"repaired": 0, "replicas_created": 0,
                    "unrepairable": out["unrepairable"]}
        self.stats.add(extents_repaired=out["repaired"],
                       replicas_created=out["replicas_created"],
                       bytes_recopied=recopied)
        if canonical_moved:
            # The block-cache/plan-cache canonical key changed for at
            # least one extent: evict the inode from the cluster-shared
            # caches.  (Per-client plan caches are version-validated — the
            # ReplaceExtentPtrs version bump invalidates them; per-client
            # block caches keyed on the dead pointer still name immutable
            # bytes and simply age out.)
            drops = 0
            if cluster.shared_plan_cache is not None:
                drops += cluster.shared_plan_cache.drop_inode(inode_id)
            if cluster.shared_block_cache is not None:
                drops += cluster.shared_block_cache.drop_inode(inode_id)
            self.stats.add(cache_drops=drops)
        return out
