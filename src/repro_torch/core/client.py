"""The WTF client library (paper §2.1–§2.6) — assembly of the layered client.

The client is where metadata (WarpKV) and data (storage servers) combine
into a coherent filesystem.  The implementation is split into layers:

  * ``client_runtime`` — fd table, op logging, the auto-commit retry loop,
    and ``WtfTransaction`` (the §2.6 replay layer);
  * ``slice_ops``      — the data plane (slice planning, batched fetching
    through ``iosched``, write/paste engines) and the file-slicing API
    (Table 1) plus vectored ``yankv``/``pastev``;
  * ``posix_ops``      — the POSIX-style surface with one-lookup open
    (§2.4) plus vectored ``readv``/``preadv``/``writev``/``pwritev``;
  * ``handle``         — ``WtfFile``, the first-class handle returned by
    ``open_file`` (preferred over raw fd juggling);
  * ``iosched``        — the batched slice-fetch scheduler: coalesces
    adjacent slice pointers per (server, backing file) and fans fetches
    out across servers.

This module assembles ``WtfClient`` from those layers and defines
``Cluster``, which wires together the four components of Figure 1.

Writers create slices on storage servers *before* their metadata commits, so
any transaction that can observe a slice pointer can safely dereference it —
the cornerstone invariant of the design (§2.1).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

# Re-exported for compatibility: these names historically lived here.
from .client_runtime import (SEEK_CUR, SEEK_END, SEEK_SET,  # noqa: F401
                             ClientRuntime, ClientStats, WtfTransaction,
                             basename_of, normalize_path, parent_of)
from .errors import StorageError
from .handle import WtfFile  # noqa: F401  (re-export)
from .blockcache import DEFAULT_BLOCK_CACHE_BYTES, BlockCache
from .inode import DEFAULT_REGION_SIZE, REGION_COMPACT_THRESHOLD
from .iort import HealthTracker, IoRuntime, PlanCache, run_with_failover
from .repair import RepairQueue, RepairStats, RepairTicket
from .iosched import DEFAULT_MAX_GAP, SliceScheduler
from .lease import LeaseHub, LeaseTable
from .mdshard import ShardedKV
from .wsched import DEFAULT_MAX_COALESCE, StoreRequest, WriteScheduler
from .metadata import WarpKV
from .posix_ops import PosixOps
from .slice_ops import SliceOps
from .slicing import ResolvedIndexCache, SlicePointer

GC_DIR = "/.wtf-gc"          # reserved directory for GC live lists (§2.8)


class WtfClient(PosixOps, SliceOps, ClientRuntime):
    """One application's handle on the filesystem.

    Not thread-safe by design: the paper's workloads use one client per
    thread/process; share the ``Cluster`` instead, which is thread-safe.

    Surface (see the layer modules for details):

      * POSIX ops with one-lookup open, plus vectored
        ``readv``/``preadv``/``writev``/``pwritev``;
      * file slicing (``yank``/``paste``/``punch``/``append``/``concat``/
        ``copy``) plus vectored ``yankv``/``pastev``;
      * ``open_file`` returning a ``WtfFile`` context-manager handle;
      * fully general multi-file transactions via ``transaction()`` with
        the §2.6 transparent-replay retry layer.

    Every vectored call executes as ONE logged op in ONE transaction, and
    its slice fetches are batched by the cluster's ``SliceScheduler``.
    """

    def __init__(self, cluster: "Cluster", client_id: Optional[int] = None):
        from .wbuf import WriteBehindBuffer

        self.cluster = cluster
        self.kv: WarpKV = cluster.kv
        self.stats = ClientStats()
        # Leased metadata cache (``lease``): on lease-enabled clusters every
        # transaction this client begins serves reads from (and grants)
        # time/version-bounded leases, and read-only transactions whose
        # whole read set is lease-covered commit with zero KV round trips.
        self._lease_table = (LeaseTable(cluster.lease_hub)
                             if cluster.lease_hub is not None else None)
        self._client_id = (client_id if client_id is not None
                           else cluster._next_client_id())
        self._fd_counter = itertools.count(3)
        self._fds: Dict[int, Any] = {}
        self._id_counter = itertools.count(1)
        self._txn: Optional[WtfTransaction] = None
        # Write-behind: slice stores deferred into ``_wb`` flush in one
        # scheduled pass at the commit boundary (``wbuf``).  The client
        # inherits the cluster knob; ``WtfFile(buffered=True)`` raises
        # ``_op_buffered`` per call for handle-level opt-in.
        self.write_behind = cluster.write_behind
        self._op_buffered = False
        self._wb = WriteBehindBuffer()
        # Read-plan cache (``iort.PlanCache``): hot re-reads skip overlay
        # resolution when the touched regions' KV versions are unchanged —
        # the commutes a commit applies bump them, which is the whole
        # invalidation story.  Per-client by default: validation records
        # the same read dependencies a fresh plan would.  Lease-enabled
        # clusters share ONE cache across all clients under the same rule
        # (hits are version-validated per transaction), with the lease hub
        # evicting an inode's plans when its region metadata changes.
        self._plan_cache = (cluster.shared_plan_cache
                            if cluster.shared_plan_cache is not None
                            else PlanCache())
        # Data-block cache (``blockcache.BlockCache``): hot re-reads skip
        # the storage round entirely.  Same sharing and invalidation rule
        # as the plan cache — cluster-shared on lease clusters, evicted
        # jointly with the inode's plans when a commit (or lease
        # revocation) invalidates them; ``Cluster(block_cache_bytes=0)``
        # disables it.
        if cluster.shared_block_cache is not None:
            self._block_cache = cluster.shared_block_cache
        elif cluster.block_cache_bytes > 0:
            from .blockcache import BlockCache
            self._block_cache = BlockCache(cluster.block_cache_bytes)
        else:
            self._block_cache = None
        # Resolved-region index (``slicing.ResolvedIndexCache``): when a
        # hot region's overlay list grows by k extents, its resolved form
        # is extended in O(k log n) instead of re-resolved over the whole
        # write history.  Per-client, identity-validated (a false hit is
        # impossible); disabled via ``Cluster(resolved_index=False)``.
        self._rcache = (ResolvedIndexCache()
                        if cluster.resolved_index else None)
        self.time_fn: Callable[[], int] = lambda: int(time.time())


class Cluster:
    """Wires together the four components of Figure 1 and owns shared state.

    Thread-safe; create one ``WtfClient`` per worker thread on top of it.
    Owns the ``SliceScheduler`` (one per cluster, shared by all clients) so
    batched fetches from every client share one thread pool and one
    coalescing policy (``fetch_gap_bytes``), and its write-side mirror, the
    ``WriteScheduler`` (``wsched``), which shares the same pool.

    The store pipeline: the client plans every slice creation of an op as a
    ``StoreRequest``; ``store_slices`` groups them by (replica candidate
    servers, backing-file hint), packs runs of small requests (at most
    ``store_coalesce_bytes`` each) into covering stores, issues ONE
    ``create_slices`` round per (group, replica) — concurrently across
    distinct servers — and falls back to the next ring owner on
    ``StorageError`` (§2.9).  ``store_batching=False`` degrades to the
    scalar one-round-per-slice path (same results, more rounds).  Effects
    are measured by ``ClientStats.store_batches`` / ``slices_store_coalesced``
    / ``degraded_stores`` and server-side ``StorageStats.slices_written``.
    """

    def __init__(self, n_servers: int = 4, data_dir: str = "/tmp/wtf",
                 replication: int = 1,
                 region_size: int = DEFAULT_REGION_SIZE,
                 coordinator_replicas: int = 3,
                 num_backing_files: int = 8,
                 fetch_gap_bytes: Optional[int] = None,
                 fetch_workers: Optional[int] = None,
                 store_coalesce_bytes: Optional[int] = None,
                 store_batching: bool = True,
                 write_behind: bool = False,
                 scatter_gather: bool = True,
                 resolved_index: bool = True,
                 readahead: bool = True,
                 block_cache_bytes: int = DEFAULT_BLOCK_CACHE_BYTES,
                 region_compact_threshold: Optional[int] =
                 REGION_COMPACT_THRESHOLD,
                 kv_group_commit: bool = True,
                 n_meta_shards: int = 1,
                 lease_ttl: Optional[float] = None,
                 kv_service_time: float = 0.0,
                 storage_service_time: float = 0.0,
                 io_deadline_s: Optional[float] = None,
                 min_read_replicas: int = 1,
                 strict_replication: bool = False,
                 health_seed: int = 0):
        from .coordinator import ReplicatedCoordinator
        from .placement import HashRing
        from .storage import DEFAULT_READAHEAD_POOL_BYTES, StorageServer
        import os

        # Knob validation up front: a bad threshold or an unachievable
        # replica count must fail HERE, not misbehave mid-op (a negative
        # gap silently disables coalescing; replication > n_servers makes
        # every store degraded from the first write on).
        if n_servers < 1:
            raise ValueError(f"n_servers must be >= 1, got {n_servers}")
        if replication < 1:
            raise ValueError(f"replication must be >= 1, got {replication}")
        if replication > n_servers:
            raise ValueError(
                f"replication={replication} exceeds n_servers={n_servers}: "
                f"replicas must land on distinct servers (§2.9)")
        if region_size <= 0:
            raise ValueError(f"region_size must be > 0, got {region_size}")
        if fetch_gap_bytes is not None and fetch_gap_bytes <= 0:
            raise ValueError(
                f"fetch_gap_bytes must be > 0 (or None for adaptive), "
                f"got {fetch_gap_bytes}")
        if store_coalesce_bytes is not None and store_coalesce_bytes <= 0:
            raise ValueError(
                f"store_coalesce_bytes must be > 0 (or None for adaptive), "
                f"got {store_coalesce_bytes}")
        if fetch_workers is not None and fetch_workers < 1:
            raise ValueError(
                f"fetch_workers must be >= 1, got {fetch_workers}")
        if region_compact_threshold is not None \
                and region_compact_threshold < 2:
            raise ValueError(
                f"region_compact_threshold must be >= 2 (or None to "
                f"disable), got {region_compact_threshold}")
        if n_meta_shards < 1:
            raise ValueError(
                f"n_meta_shards must be >= 1, got {n_meta_shards}")
        if lease_ttl is not None and lease_ttl <= 0:
            raise ValueError(
                f"lease_ttl must be > 0 (or None to disable leases), "
                f"got {lease_ttl}")
        if kv_service_time < 0:
            raise ValueError(
                f"kv_service_time must be >= 0, got {kv_service_time}")
        if storage_service_time < 0:
            raise ValueError(
                f"storage_service_time must be >= 0, "
                f"got {storage_service_time}")
        if not isinstance(block_cache_bytes, int) or block_cache_bytes < 0:
            raise ValueError(
                f"block_cache_bytes must be an int >= 0 (0 disables the "
                f"client data-block cache), got {block_cache_bytes!r}")
        if io_deadline_s is not None and io_deadline_s <= 0:
            raise ValueError(
                f"io_deadline_s must be > 0 (or None to disable per-round "
                f"deadlines), got {io_deadline_s}")
        if not 1 <= min_read_replicas <= replication:
            raise ValueError(
                f"min_read_replicas must be in [1, replication="
                f"{replication}], got {min_read_replicas}")

        # Metadata plane: ONE WarpKV by default — the exact single-store
        # fast path — or a ``mdshard.ShardedKV`` partitioning the keyspace
        # across ``n_meta_shards`` independent WarpKV shards, with
        # cross-shard transactions (rare by construction: inode ids are
        # colocated with their paths) going through 2PC.
        self.n_meta_shards = n_meta_shards
        if n_meta_shards == 1:
            self.kv = WarpKV(group_commit=kv_group_commit,
                             service_time_s=kv_service_time)
        else:
            self.kv = ShardedKV(n_meta_shards, group_commit=kv_group_commit,
                                service_time_s=kv_service_time)
        # Leases (``lease``): time/version-bounded client metadata caching.
        # The hub wires revocation (writer-side invalidation barrier + the
        # per-shard WAL subscribe stream) and owns the cluster-shared
        # version-validated plan cache.
        self.lease_ttl = lease_ttl
        # Data-plane read caching knobs: server-side readahead pools and
        # the client block cache share the plan cache's invalidation rule
        # (see ``blockcache``); each has an off position so benchmarks can
        # isolate its contribution.
        self.readahead = readahead
        self.block_cache_bytes = block_cache_bytes
        if lease_ttl is not None:
            self.shared_plan_cache = PlanCache()
            self.shared_block_cache = (BlockCache(block_cache_bytes)
                                       if block_cache_bytes > 0 else None)
            self.lease_hub = LeaseHub(self.kv, ttl=lease_ttl,
                                      plan_cache=self.shared_plan_cache,
                                      block_cache=self.shared_block_cache)
        else:
            self.shared_plan_cache = None
            self.shared_block_cache = None
            self.lease_hub = None
        # Metadata-plane fast-path knobs (all default on; each has an off
        # position so benchmarks/tests can compare like for like):
        #   scatter_gather — one retrieve_slices round per (server,
        #     backing file) fetch group instead of one per coalesced run;
        #   resolved_index — per-client delta-maintained region overlays;
        #   region_compact_threshold — commit-time CompactRegion trigger.
        self.scatter_gather = scatter_gather
        self.resolved_index = resolved_index
        self.region_compact_threshold = region_compact_threshold
        self.region_size = region_size
        self.replication = replication
        self.coordinator = ReplicatedCoordinator(coordinator_replicas)
        self.servers: Dict[int, Any] = {}
        self._ring = HashRing()
        self._ring_epoch = -1
        # Memoized ring walks for the scalar store path: every append to
        # the same region re-derives the same owner list, and the walk
        # was measurable GIL-held time under many appenders.  Cleared on
        # every ring refresh (stale reads race exactly like ``_ring``
        # itself and are caught by the per-store failover walk).
        self._owners_cache: Dict[Any, List[int]] = {}
        self._lock = threading.Lock()
        self._client_ids = itertools.count(1)
        for sid in range(n_servers):
            root = os.path.join(data_dir, f"server_{sid:03d}")
            srv = StorageServer(sid, root,
                                num_backing_files=num_backing_files,
                                service_time_s=storage_service_time,
                                readahead_pool_bytes=(
                                    DEFAULT_READAHEAD_POOL_BYTES
                                    if readahead else 0))
            self.servers[sid] = srv
            self.coordinator.register_server(sid, root)
        self._refresh_ring()
        # The unified async I/O runtime (``iort``): the ONE thread pool and
        # submission queue both scheduler strategy layers and the async
        # client surface execute on, plus the adaptive-threshold cost
        # model.  Explicit gap/coalesce knobs pin the thresholds; None
        # (the default) sizes them from observed round-trip cost.
        self.runtime = IoRuntime(
            max_workers=(fetch_workers if fetch_workers is not None
                         else min(8, max(1, n_servers))),
            gap_override=fetch_gap_bytes,
            coalesce_override=store_coalesce_bytes)
        if readahead:
            # Readahead windows size themselves from the same EWMA cost
            # model as adaptive coalescing (the bytes one round trip is
            # worth); wire it now that the runtime exists.
            for srv in self.servers.values():
                srv.readahead_window = self.runtime.readahead_bytes
        self.scheduler = SliceScheduler(self, self.runtime)
        self.store_batching = store_batching
        # Write-behind (opt-in): clients defer slice stores into a
        # transaction-scoped buffer and flush them through ``wsched`` as
        # ONE planning pass at each commit boundary — cross-op chunks in a
        # region coalesce into covering stores, regions fan out in
        # parallel, and metadata commits only after every slice is durable
        # (§2.1).  Measured by ``ClientStats.writeback_flushes`` /
        # ``slices_cross_op_coalesced``.
        self.write_behind = write_behind
        self.wsched = WriteScheduler(self, self.runtime)
        self.degraded_stores = 0     # replica sets that came up short (§2.9)
        # Failure domain (§2.9 + the repair plane):
        #   health    — per-server circuit breaker + latency EWMA consulted
        #               by every failover walk, so dead servers are skipped
        #               up front instead of paying a failed round each time;
        #   io_deadline_s — per-replica-round budget; with it set, slow
        #               rounds get ONE hedged retry on the next replica
        #               before the deadline abandons them;
        #   min_read_replicas — reads that find fewer live replicas raise
        #               typed ``DegradedRead`` instead of silently serving;
        #   strict_replication — writes that achieve fewer than
        #               ``replication`` replicas raise instead of degrading
        #               (either way a repair ticket is queued first);
        #   repair_queue/repair_stats — cluster-owned so degrade sites can
        #               file tickets and ``total_stats`` reports them even
        #               before any ``repair.RepairDaemon`` is attached.
        self.io_deadline_s = io_deadline_s
        self.min_read_replicas = min_read_replicas
        self.strict_replication = strict_replication
        self.health = HealthTracker(seed=health_seed)
        self.repair_stats = RepairStats()
        self.repair_queue = RepairQueue(self.repair_stats)
        self._repair_daemon: Optional[Any] = None
        self._closed = False
        self._root_client = WtfClient(self, client_id=0)
        self._root_client.mkfs()

    # ----------------------------------------------------------- membership
    def _next_client_id(self) -> int:
        return next(self._client_ids)

    def _refresh_ring(self) -> None:
        from .placement import HashRing

        cfg = self.coordinator.config()
        ring = HashRing(cfg["online"])
        self._owners_cache.clear()
        with self._lock:
            self._ring = ring
            self._ring_epoch = cfg["epoch"]

    def fail_server(self, server_id: int) -> None:
        self.servers[server_id].crash()
        self.coordinator.fail_server(server_id)
        self._refresh_ring()

    def recover_server(self, server_id: int) -> None:
        self.servers[server_id].recover()
        self.coordinator.recover_server(server_id)
        # Forget the circuit-breaker history: a recovered server serves
        # immediately instead of waiting out its pre-crash backoff.
        self.health.reset(server_id)
        self._refresh_ring()

    def client(self) -> WtfClient:
        return WtfClient(self)

    # ------------------------------------------------------------- data I/O
    def store_slice(self, data: bytes, placement_key: Any,
                    hint: int) -> Tuple[SlicePointer, ...]:
        """Create ``replication`` replica slices on distinct servers (§2.9).

        On server failure, falls back to the next servers on the ring — the
        write path never blocks on a single faulty node.
        """
        want = self.replication
        candidates = self._owners_cache.get(placement_key)
        if candidates is None:
            candidates = self._ring.owners(placement_key, len(self.servers))
            self._owners_cache[placement_key] = candidates
        ptrs: list[SlicePointer] = []
        for sid in candidates:
            if len(ptrs) == want:
                break
            srv = self.servers.get(sid)
            if srv is None or not srv.alive or not self.health.allow(sid):
                continue
            t0 = time.perf_counter()
            try:
                ptrs.append(srv.create_slice(data, locality_hint=hint))
            except StorageError:
                self.health.record_failure(sid)
                self._on_server_error(sid)
            else:
                self.health.record_success(sid, time.perf_counter() - t0)
        if not ptrs:
            raise StorageError("no storage server could accept the slice")
        if len(ptrs) < want:
            # Under-replicated, not failed: the write stays available, but
            # the shortfall must never be silent (§2.9) — count it AND file
            # a repair ticket carrying the extent identity, so the repair
            # plane can re-replicate without a full metadata scan.
            self.note_degraded_stores(1)
            self.enqueue_repair(placement_key, ptrs=ptrs)
            if self.strict_replication:
                raise StorageError(
                    f"strict_replication: achieved {len(ptrs)}/{want} "
                    f"replicas for {placement_key!r}")
        return tuple(ptrs)

    def store_slices(self, requests: Sequence[StoreRequest],
                     stats=None) -> dict:
        """Batched stores through the write scheduler (see class docstring);
        ``store_batching=False`` falls back to one scalar round per request
        so benchmarks/tests can compare the two pipelines like for like."""
        if self.store_batching:
            return self.wsched.store_many(requests, stats=stats)
        out = {}
        for r in requests:
            ptrs = self.store_slice(r.data, r.placement_key, r.hint)
            out[r.key] = ptrs
            if stats is not None:
                stats.add(store_batches=len(ptrs),
                          data_bytes_written=len(r.data) * len(ptrs),
                          degraded_stores=(1 if len(ptrs) < self.replication
                                           else 0))
        return out

    def release_slices(self, ptrs: Sequence[SlicePointer]) -> None:
        """End-of-transaction ACK for the tier-3 GC handoff window: the
        transaction that created ``ptrs`` has committed or finally
        aborted, so the servers may stop shielding those ranges from the
        sparse rewrite (§2.8).  Safe to call with foreign/stale pointers;
        releasing twice is a no-op."""
        by_server: dict[int, list[SlicePointer]] = {}
        for p in ptrs:
            by_server.setdefault(p.server_id, []).append(p)
        for sid, plist in by_server.items():
            srv = self.servers.get(sid)
            if srv is not None:
                srv.release_slices(plist)

    def note_degraded_stores(self, n: int) -> None:
        with self._lock:
            self.degraded_stores += n

    def enqueue_repair(self, placement_key: Any,
                       ptrs: Optional[Sequence[SlicePointer]] = None,
                       reason: str = "degraded-store") -> None:
        """File a repair ticket for a store that came up short.  The
        placement key carries the (inode, region) identity; keys the
        parser does not recognize are counted and left to the periodic
        under-replication scan."""
        self.repair_queue.put_from_placement(placement_key, ptrs, reason)

    def note_failed_retrieve(self, inode_id: int) -> None:
        """File a repair ticket for a read that had to fail over past a
        dead replica: the read path knows the inode but not which region
        the extent belongs to, so the ticket covers the whole inode."""
        self.repair_queue.put(RepairTicket(inode_id=inode_id,
                                           reason="failed-retrieve"))

    def fetch_slice(self, ptrs: Sequence[SlicePointer]) -> bytes:
        """Read any replica; fail over across them via the runtime's
        unified candidate walk (§2.9)."""
        return run_with_failover(
            self, [(p.server_id, p) for p in ptrs],
            lambda srv, p: srv.retrieve_slice(p))

    def _on_server_error(self, server_id: int) -> None:
        try:
            self.coordinator.fail_server(server_id)
        except Exception:
            pass
        self._refresh_ring()

    # ------------------------------------------------------------- stats
    def total_stats(self) -> dict:
        agg = {
            "kv": self.kv.stats.snapshot(),
            "servers": {sid: s.stats.snapshot()
                        for sid, s in self.servers.items()},
        }
        agg["data_bytes_written"] = sum(
            s["bytes_written"] for s in agg["servers"].values())
        agg["data_bytes_read"] = sum(
            s["bytes_read"] for s in agg["servers"].values())
        agg["slices_read"] = sum(
            s["slices_read"] for s in agg["servers"].values())
        agg["slices_written"] = sum(
            s["slices_written"] for s in agg["servers"].values())
        agg["append_lock_wait_s"] = sum(
            s["append_lock_wait_s"] for s in agg["servers"].values())
        agg["degraded_stores"] = self.degraded_stores
        agg["io_runtime"] = self.runtime.snapshot()
        agg["io_health"] = self.health.snapshot()
        agg["repair"] = self.repair_stats.snapshot()
        agg["repair"]["tickets_pending"] = len(self.repair_queue)
        # Sharded metadata plane: per-shard KVStats plus the 2PC
        # coordinator's counters (each snapshot is atomic, like the
        # ``io_runtime`` section; the top-level "kv" stays the aggregate).
        kv = self.kv
        if isinstance(kv, ShardedKV):
            agg["kv_shards"] = [sh.stats.snapshot() for sh in kv.shards]
            agg["mdshard"] = kv.stats_2pc.snapshot()
        if self.lease_hub is not None:
            agg["leases"] = self.lease_hub.stats.snapshot()
        return agg

    def reset_io_stats(self) -> None:
        from .storage import StorageStats

        for s in self.servers.values():
            s.stats = StorageStats()
        with self._lock:
            self.degraded_stores = 0

    def close(self) -> None:
        """Idempotent teardown: repair daemon first (it drives the runtime
        and the servers), then the runtime (every in-flight async future
        resolves and all pool threads exit), then the servers."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        daemon = self._repair_daemon
        if daemon is not None:
            daemon.stop()
        self.runtime.close()
        for s in self.servers.values():
            s.close()
