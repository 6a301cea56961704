"""Unified async I/O runtime — the single data-plane engine under both
schedulers.

Before this module, the read scheduler (``iosched``) and write scheduler
(``wsched``) were two near-duplicate engines: each had its own grouping
logic, its own failover loop, and the read side owned the thread pool the
write side borrowed.  The paper's performance story (§4) is that cheap
slice-pointer metadata work overlaps with batched data-plane rounds; a
client that serializes every ``readv``/``writev`` against its scheduler
forfeits exactly that overlap.  This module hosts everything the two
directions share, and the pieces the overlap needs:

  * **One pool, one submission queue.**  ``IoRuntime`` owns the only
    thread pool in the client stack.  Work is submitted as ``IoTask``s —
    a fetch batch, a store-group replica round, or a whole async client
    op — and completes through futures.  Both schedulers are thin
    strategy layers: they *plan* (group/coalesce/pack) and hand the
    resulting tasks here for execution, timing and failover accounting.
  * **Futures-based completion.**  ``submit_op`` runs an entire client op
    on the pool and returns an ``IoFuture``; the async surface
    (``readv_async``/``writev_async`` and friends) is built on it, so
    metadata planning for op N+1 overlaps the data rounds of op N
    (CannyFS, arXiv 1612.06830, measures how much this buys in exactly
    this batch-transactional setting).  A round dispatched *from* a pool
    worker runs inline rather than re-entering the queue, so async ops
    can never deadlock the pool against itself.
  * **Unified replica failover.**  ``run_with_failover`` is the one
    candidate-walk loop both directions use (§2.9): skip dead servers,
    mark a ``StorageError`` server failed with the coordinator, move to
    the next candidate, and surface exhaustion to the caller's
    degraded/fatal policy.
  * **Adaptive coalescing.**  Every round observed through the runtime
    updates an EWMA cost model (per-server round-trip cost plus a global
    bandwidth estimate).  The gap/pack thresholds the schedulers use are
    sized from it — the bytes one round-trip is worth — replacing the two
    fixed 32 KiB constants.  Explicit ``fetch_gap_bytes`` /
    ``store_coalesce_bytes`` knobs pin the thresholds and disable
    adaptation (benchmarks pin them so paper-reproduction accounting
    stays comparable across runs).
  * **Read-plan cache.**  ``PlanCache`` memoizes resolved read plans
    keyed on ``(inode, requested ranges)`` and *validated* against the
    region versions observed when the plan was built — the commutes a
    commit applies bump those versions, so invalidation is exactly the
    KV's own conflict rule (FaaSFS-style version-keyed client caching).
    Pending write-behind extents never enter the cache, mirroring
    ``overlay_cached``.
  * **Atomic stats.**  ``AtomicStatsMixin`` routes every counter
    mutation through a per-stats lock; with rounds and whole ops running
    on pool threads, the bare ``+=`` updates ``ClientStats`` and
    ``StorageStats`` used before this PR were lost-update races.
"""
from __future__ import annotations

import itertools
import queue as _queue
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .errors import DeadlineExceeded, ReplicaExhausted, StorageError
from .placement import stable_hash
from .testing import witness_lock

# Seed/floor/ceiling for the adaptive thresholds.  The seed matches the old
# fixed constant so a fresh cluster behaves identically until it has
# observed real rounds; the clamps keep a noisy estimate from degenerating
# into no coalescing at all or whole-file over-reads.
ADAPTIVE_SEED = 32 << 10
ADAPTIVE_FLOOR = 4 << 10
ADAPTIVE_CEILING = 256 << 10

# Server readahead window clamps (see IoRuntime.readahead_bytes): deep
# enough to cover several coalesced batches of a sequential stream, small
# enough that a handful of concurrent streams fit one server's pool.
READAHEAD_FLOOR = 128 << 10
READAHEAD_CEILING = 4 << 20

# EWMA blend weight for new observations (two-ish dozen rounds to converge).
_EWMA_ALPHA = 0.15

# Health-tracker policy (see HealthTracker): a server is circuit-broken
# after this many consecutive failures, backs off exponentially from the
# base up to the cap (plus deterministic seeded jitter, so a fleet of
# clients never probes in lockstep), and a hedged retry fires when a round
# runs past this multiple of the server's EWMA latency.
HEALTH_FAILURE_THRESHOLD = 3
HEALTH_BACKOFF_BASE_S = 0.05
HEALTH_BACKOFF_CAP_S = 5.0
HEALTH_JITTER_FRAC = 0.25
HEDGE_EWMA_MULTIPLIER = 4.0
HEDGE_MIN_S = 0.001
# Rounds at most this big estimate fixed per-round cost; rounds at least
# this big estimate bandwidth.  In between they update neither cleanly.
_SMALL_ROUND_BYTES = 4 << 10
_LARGE_ROUND_BYTES = 64 << 10


class AtomicStatsMixin:
    """Lock-guarded counter mutation for the stats dataclasses.

    Pool threads bump ``ClientStats`` (async ops) and ``StorageStats``
    (concurrent rounds) concurrently with the application thread; a bare
    ``+=`` on an attribute is a read-modify-write race.  All mutation goes
    through ``add``; ``snapshot`` reads under the same lock.

    Declares empty ``__slots__`` and reads fields via dataclass
    introspection so the (heavily-instantiated, hot-path) stats
    dataclasses can opt into ``slots=True`` without growing a ``__dict__``.
    """

    __slots__ = ()

    def add(self, **deltas: int) -> None:
        with self._stats_lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + delta)

    def snapshot(self) -> dict:
        import dataclasses as _dc

        with self._stats_lock:
            return {f.name: getattr(self, f.name)
                    for f in _dc.fields(self)
                    if not f.name.startswith("_")}


class IoTask:
    """One unit of data-plane work submitted to the runtime.

    ``kind`` is ``"fetch"`` / ``"store"`` for storage-server rounds (timed
    into the adaptive cost model) or ``"op"`` for a whole async client op
    (not a round — excluded from the model).  ``server_id``/``nbytes`` may
    be refined by the executing function (e.g. the store path only knows
    its server after the ring walk claims one).
    """

    __slots__ = ("kind", "server_id", "nbytes", "payload")

    def __init__(self, kind: str, server_id: Optional[int] = None,
                 nbytes: int = 0, payload: Any = None):
        self.kind = kind
        self.server_id = server_id
        self.nbytes = nbytes
        self.payload = payload


class IoFuture:
    """Future for an async client op.

    Thin wrapper over ``concurrent.futures.Future`` that records, in the
    owning client's stats, whether the caller had to *block* for the
    result (``blocked_waits``) — the counter the pipeline overlap
    benchmark uses to show async prefetch hiding data rounds behind
    compute.
    """

    __slots__ = ("_fut", "_stats", "_counted")

    def __init__(self, fut: Future, stats=None):
        self._fut = fut
        self._stats = stats
        self._counted = False

    @classmethod
    def resolved(cls, value: Any) -> "IoFuture":
        f: Future = Future()
        f.set_result(value)
        return cls(f)

    def done(self) -> bool:
        return self._fut.done()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._fut.done() and self._stats is not None \
                and not self._counted:
            self._counted = True
            self._stats.add(blocked_waits=1)
        return self._fut.result(timeout)

    def exception(self, timeout: Optional[float] = None):
        return self._fut.exception(timeout)

    def add_done_callback(self, fn: Callable[["IoFuture"], None]) -> None:
        self._fut.add_done_callback(lambda _f: fn(self))


class _ServerHealth:
    """Per-server circuit state (mutated only under HealthTracker._lock)."""

    __slots__ = ("consecutive_failures", "ewma_latency_s", "open_until",
                 "backoff_exp", "probing", "failures_total", "opens")

    def __init__(self):
        self.consecutive_failures = 0
        self.ewma_latency_s: Optional[float] = None
        self.open_until = 0.0          # monotonic time the circuit re-arms
        self.backoff_exp = 0           # consecutive re-opens (backoff power)
        self.probing = False           # one half-open probe in flight
        self.failures_total = 0
        self.opens = 0


class HealthTracker:
    """Per-server failure memory behind the §2.9 candidate walk.

    The stateless walk re-probed every dead server on every round — one
    wasted timeout per round per corpse.  This tracker gives the walk
    memory, as a classic circuit breaker:

      * **closed** — fewer than ``failure_threshold`` consecutive failures:
        the server is tried normally.  Successes record an EWMA of round
        latency (feeds the hedge threshold) and reset the failure count.
      * **open** — at the threshold the circuit opens for an exponentially
        growing backoff (base × 2^n, capped) plus *deterministic seeded
        jitter* — ``stable_hash(seed, sid, opens)`` spreads a fleet's
        probes without making any test run nondeterministic.  While open,
        ``allow`` says no and the walk skips the server up front.
      * **half-open** — once the backoff elapses, exactly ONE caller is
        admitted as a probe; success closes the circuit (and resets the
        backoff exponent), failure re-opens it with a doubled backoff.

    ``reset`` (wired to ``Cluster.recover_server``) clears a server's
    state when an operator declares it healthy.  All state lives under the
    ``iort.health`` lock (ranked in ``analysis.lockspec``); nothing blocks
    under it.  Counters surface via ``snapshot()`` in ``total_stats()``.
    """

    def __init__(self, seed: int = 0,
                 failure_threshold: int = HEALTH_FAILURE_THRESHOLD,
                 backoff_base_s: float = HEALTH_BACKOFF_BASE_S,
                 backoff_cap_s: float = HEALTH_BACKOFF_CAP_S,
                 clock: Callable[[], float] = time.monotonic):
        self._lock = witness_lock(threading.Lock(), "iort.health")
        self._seed = seed
        self._threshold = max(1, failure_threshold)
        self._backoff_base_s = backoff_base_s
        self._backoff_cap_s = backoff_cap_s
        self._clock = clock
        self._servers: Dict[int, _ServerHealth] = {}
        # Walk-level counters (guarded by the same lock).
        self._skips = 0
        self._probes = 0
        self._hedged_rounds = 0
        self._deadline_timeouts = 0

    def _state(self, sid: int) -> _ServerHealth:
        st = self._servers.get(sid)
        if st is None:
            st = self._servers[sid] = _ServerHealth()
        return st

    def _jitter(self, sid: int, n: int) -> float:
        """Deterministic jitter fraction in [0, 1): seeded, per (server,
        re-open count), stable across runs and threads."""
        return (stable_hash(self._seed, sid, n, salt="health")
                % 10_000) / 10_000.0

    def allow(self, sid: int) -> bool:
        """May the walk try ``sid`` right now?  Grants the single half-open
        probe token when an open circuit's backoff has elapsed."""
        with self._lock:
            st = self._servers.get(sid)
            if st is None or st.consecutive_failures < self._threshold:
                return True
            if st.probing:
                self._skips += 1
                return False
            if self._clock() >= st.open_until:
                st.probing = True
                self._probes += 1
                return True
            self._skips += 1
            return False

    def record_success(self, sid: int, seconds: float) -> None:
        with self._lock:
            st = self._state(sid)
            st.consecutive_failures = 0
            st.backoff_exp = 0
            st.probing = False
            st.open_until = 0.0
            if seconds > 0:
                prev = st.ewma_latency_s
                st.ewma_latency_s = (
                    seconds if prev is None
                    else prev + _EWMA_ALPHA * (seconds - prev))

    def record_failure(self, sid: int) -> None:
        with self._lock:
            st = self._state(sid)
            st.failures_total += 1
            st.consecutive_failures += 1
            st.probing = False
            if st.consecutive_failures < self._threshold:
                return
            backoff = min(self._backoff_cap_s,
                          self._backoff_base_s * (2 ** st.backoff_exp))
            backoff *= 1.0 + HEALTH_JITTER_FRAC * self._jitter(sid, st.opens)
            st.open_until = self._clock() + backoff
            st.backoff_exp += 1
            st.opens += 1

    def reset(self, sid: int) -> None:
        """Operator-declared recovery: forget the server's failure state."""
        with self._lock:
            self._servers.pop(sid, None)

    def hedge_threshold_s(self, sid: int, deadline_s: float) -> float:
        """When to fire the hedged retry for a round on ``sid``: a multiple
        of the server's EWMA latency (a healthy round should be long done),
        clamped into (HEDGE_MIN_S, deadline)."""
        with self._lock:
            st = self._servers.get(sid)
            ewma = st.ewma_latency_s if st is not None else None
        if ewma is None:
            return deadline_s / 2
        return max(HEDGE_MIN_S, min(deadline_s, ewma * HEDGE_EWMA_MULTIPLIER))

    def note_hedge(self) -> None:
        with self._lock:
            self._hedged_rounds += 1

    def note_deadline_timeout(self) -> None:
        with self._lock:
            self._deadline_timeouts += 1

    def snapshot(self) -> dict:
        with self._lock:
            servers = {
                sid: {
                    "consecutive_failures": st.consecutive_failures,
                    "failures_total": st.failures_total,
                    "circuit_open": (st.consecutive_failures
                                     >= self._threshold),
                    "opens": st.opens,
                    "ewma_latency_s": st.ewma_latency_s,
                }
                for sid, st in self._servers.items()}
            return {
                "servers_skipped": self._skips,
                "half_open_probes": self._probes,
                "hedged_rounds": self._hedged_rounds,
                "deadline_timeouts": self._deadline_timeouts,
                "circuit_opens": sum(st.opens
                                     for st in self._servers.values()),
                "servers": servers,
            }


def run_with_failover(cluster, candidates: Sequence[Tuple[int, Any]],
                      attempt: Callable[[Any, Any], Any],
                      release: Optional[Callable[[int], None]] = None,
                      exhausted: Optional[Callable[[Optional[Exception]],
                                                   Any]] = None) -> Any:
    """The one §2.9 candidate-walk failover loop, shared by both directions.

    Walks ``(server_id, payload)`` candidates in order: dead, missing, or
    circuit-broken servers (the cluster's ``HealthTracker``) are skipped up
    front; ``attempt(server, payload)`` returning is success (recorded into
    the server's health EWMA); a ``StorageError`` bumps the server's
    failure count, marks it failed with the coordinator
    (``cluster._on_server_error``), optionally ``release``s any claim the
    caller took on it, and moves on.  When every candidate is exhausted,
    ``exhausted(last_error)`` decides the outcome (default: raise
    ``ReplicaExhausted`` — a ``StorageError`` subclass, so existing
    degraded-path handlers keep working).

    With ``Cluster(io_deadline_s=...)`` set, rounds run with a per-round
    deadline and one hedged retry (``_run_with_deadline``): a round that
    outlives the health-EWMA-derived hedge threshold stops gating the walk.
    """
    health = getattr(cluster, "health", None)
    deadline = getattr(cluster, "io_deadline_s", None)
    if deadline is not None and health is not None:
        return _run_with_deadline(cluster, candidates, attempt, release,
                                  exhausted, health, deadline)
    last: Optional[Exception] = None
    for sid, payload in candidates:
        srv = cluster.servers.get(sid)
        if srv is None or not srv.alive or \
                (health is not None and not health.allow(sid)):
            if release is not None:
                release(sid)
            continue
        t0 = time.perf_counter()
        try:
            result = attempt(srv, payload)
        except StorageError as e:
            last = e
            if health is not None:
                health.record_failure(sid)
            if release is not None:
                release(sid)
            cluster._on_server_error(sid)
            continue
        if health is not None:
            health.record_success(sid, time.perf_counter() - t0)
        return result
    if exhausted is not None:
        return exhausted(last)
    raise ReplicaExhausted(f"all replicas unavailable: {last}")


def _run_with_deadline(cluster, candidates, attempt, release, exhausted,
                       health: HealthTracker, deadline: float) -> Any:
    """Deadline + hedged variant of the candidate walk.

    Attempts run on the runtime's dedicated hedge pool (never the shared
    round pool — a walk frequently *runs on* a round-pool worker, and
    blocking there on work only that pool could run is the classic
    self-deadlock).  The walk waits on a completion queue with three
    timers:

      * **hedge** — the first time a round outlives the server's
        health-EWMA-derived hedge threshold, ONE hedged retry is launched
        on the next candidate; first success wins, the loser is abandoned
        (reads are idempotent; an abandoned store's slices are unreferenced
        garbage the §2.8 collector reclaims).
      * **deadline** — a round older than ``io_deadline_s`` is abandoned
        and counted as a failure against the server's health (it ate a
        full timeout) without being declared dead to the coordinator —
        slow is not dead.
      * **exhaustion** — no replicas in flight and no candidates left:
        the caller's ``exhausted`` policy (default ``ReplicaExhausted``).
    """
    it = iter(candidates)
    results: "_queue.SimpleQueue" = _queue.SimpleQueue()
    tokens = itertools.count()
    inflight: Dict[int, Tuple[int, float]] = {}   # token -> (sid, start)
    last: Optional[Exception] = None
    hedged = False

    def next_live():
        for sid, payload in it:
            srv = cluster.servers.get(sid)
            if srv is None or not srv.alive or not health.allow(sid):
                if release is not None:
                    release(sid)
                continue
            return sid, payload, srv
        return None

    def launch(sid, payload, srv) -> None:
        tok = next(tokens)
        inflight[tok] = (sid, time.perf_counter())

        def body():
            try:
                results.put((tok, True, attempt(srv, payload)))
            except BaseException as e:   # noqa: BLE001 — relayed to caller
                results.put((tok, False, e))

        cluster.runtime.hedge_submit(body)

    def exhaust():
        if exhausted is not None:
            return exhausted(last)
        raise ReplicaExhausted(f"all replicas unavailable: {last}")

    first = next_live()
    if first is None:
        return exhaust()
    launch(*first)
    while True:
        now = time.perf_counter()
        timers = [t0 + deadline for (_sid, t0) in inflight.values()]
        if not hedged and len(inflight) == 1:
            (h_sid, h_t0), = inflight.values()
            timers.append(h_t0 + health.hedge_threshold_s(h_sid, deadline))
        try:
            tok, ok, val = results.get(
                timeout=max(0.0, min(timers) - now))
        except _queue.Empty:
            now = time.perf_counter()
            if not hedged and len(inflight) == 1:
                (h_sid, h_t0), = inflight.values()
                if now >= h_t0 + health.hedge_threshold_s(h_sid, deadline):
                    hedged = True        # one hedge per walk, fired or not
                    nxt = next_live()
                    if nxt is not None:
                        health.note_hedge()
                        launch(*nxt)
                        continue
            expired = [tok for tok, (_sid, t0) in inflight.items()
                       if now >= t0 + deadline]
            for tok in expired:
                sid, _t0 = inflight.pop(tok)
                health.record_failure(sid)
                health.note_deadline_timeout()
                if release is not None:
                    release(sid)
                last = DeadlineExceeded(
                    f"round on server {sid} exceeded io_deadline_s="
                    f"{deadline}")
            if not inflight:
                nxt = next_live()
                if nxt is None:
                    return exhaust()
                launch(*nxt)
            continue
        entry = inflight.pop(tok, None)
        if entry is None:
            continue                     # abandoned attempt resolved late
        sid, t0 = entry
        if ok:
            health.record_success(sid, time.perf_counter() - t0)
            return val
        if isinstance(val, StorageError):
            last = val
            health.record_failure(sid)
            if release is not None:
                release(sid)
            cluster._on_server_error(sid)
            if not inflight:
                nxt = next_live()
                if nxt is None:
                    return exhaust()
                launch(*nxt)
            continue
        raise val                        # non-StorageError: programming bug


class PlanCache:
    """Version-validated LRU of resolved read plans.

    Key: ``(inode_id, clamped ranges)``.  Value: the region versions the
    plan was built against plus the prepared per-range extent plans.  A
    lookup revalidates every version through the caller's transaction (the
    read dependency is recorded at the same version, so a hit is exactly
    as serializable as a re-plan); any commit whose commutes touched a
    region bumped its version, which is the whole invalidation story.
    Thread-safe: async ops consult it from pool workers.

    Because hits are version-validated per transaction, one cache is safe
    to share across *clients*: on lease-enabled clusters the cluster owns a
    single shared instance (see ``client.Cluster``), so a file one client
    has planned is a plan-cache hit for every other client — the same
    lease rule that lets hot re-reads skip the KV.  The lease hub evicts a
    whole inode's plans when its region metadata changes (``drop_inode``,
    fed by the WAL subscribe stream); stale entries could only fail their
    validation anyway, eviction just keeps the shared LRU useful.
    """

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self._lock = witness_lock(threading.Lock(), "cache.plan")
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        # inode id → set of live keys, so lease-driven invalidation of one
        # inode's plans is O(its entries), not a scan of the whole LRU.
        self._by_inode: dict = {}

    def get(self, key: tuple) -> Optional[tuple]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
            return entry

    def put(self, key: tuple, value: tuple) -> None:
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            self._by_inode.setdefault(key[0], set()).add(key)
            while len(self._entries) > self.maxsize:
                old, _ = self._entries.popitem(last=False)
                self._drop_index(old)

    def _drop_index(self, key: tuple) -> None:
        keys = self._by_inode.get(key[0])
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_inode[key[0]]

    def drop_inode(self, inode_id: int) -> int:
        """Evict every plan for ``inode_id``; returns entries dropped."""
        with self._lock:
            keys = self._by_inode.pop(inode_id, None)
            if not keys:
                return 0
            for key in keys:
                self._entries.pop(key, None)
            return len(keys)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_inode.clear()


class IoRuntime:
    """The cluster's single data-plane execution engine.

    One runtime per cluster, shared by every client and both scheduler
    strategy layers.  Owns the only thread pool, the adaptive-threshold
    cost model, and the failover/degraded accounting helpers.
    """

    def __init__(self, max_workers: int = 8,
                 gap_override: Optional[int] = None,
                 coalesce_override: Optional[int] = None):
        self._max_workers = max(1, max_workers)
        self._pool: Optional[ThreadPoolExecutor] = None
        # Dedicated pool for deadline/hedged replica attempts (created on
        # first use; only clusters with ``io_deadline_s`` set ever pay for
        # it).  Separate from the round pool on purpose: the failover walk
        # usually RUNS on a round-pool worker, and a worker blocking on
        # work only its own pool can execute is the self-deadlock
        # ``run_tasks``'s help-drain exists to avoid.  Hedge tasks are leaf
        # storage calls that never re-enter either pool, so sizing is just
        # capacity: two attempts (primary + hedge) per concurrent walk.
        self._hedge_pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
        self._in_worker = threading.local()
        self._closed = False
        # Adaptive cost model (guarded by _model_lock): per-server EWMA of
        # round wall time, global EWMAs of fixed round cost + bandwidth.
        self._model_lock = threading.Lock()
        self._gap_override = gap_override
        self._coalesce_override = coalesce_override
        self._rtt_by_server: Dict[int, float] = {}
        self._ewma_round_s: Optional[float] = None   # fixed per-round cost
        self._ewma_bw: Optional[float] = None        # bytes / second
        self._rounds_observed = 0
        # Pool admission delay: how long a submitted async op sat queued
        # before a worker picked it up — the runtime-side analogue of the
        # KV plane's ``commit_wait_s`` (queueing here means concurrent ops
        # are serializing on pool capacity, not on locks).
        self._ewma_op_wait_s: Optional[float] = None
        self._ops_observed = 0

    # ----------------------------------------------------------------- pool
    def _pool_get(self) -> ThreadPoolExecutor:
        pool = self._pool
        if pool is not None:
            return pool
        with self._pool_lock:
            if self._closed:
                raise RuntimeError("I/O runtime is closed")
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._max_workers,
                    thread_name_prefix="wtf-iort")
        return self._pool

    def _hedge_pool_get(self) -> ThreadPoolExecutor:
        pool = self._hedge_pool
        if pool is not None:
            return pool
        with self._pool_lock:
            if self._closed:
                raise RuntimeError("I/O runtime is closed")
            if self._hedge_pool is None:
                self._hedge_pool = ThreadPoolExecutor(
                    max_workers=2 * self._max_workers + 2,
                    thread_name_prefix="wtf-hedge")
        return self._hedge_pool

    def hedge_submit(self, fn: Callable[[], Any]) -> None:
        """Run one deadline-governed replica attempt on the hedge pool."""
        self._hedge_pool_get().submit(fn)

    def in_worker(self) -> bool:
        """True when called from one of the runtime's own pool threads."""
        return getattr(self._in_worker, "active", False)

    def close(self) -> None:
        """Drain and shut down: every submitted task (queued or running)
        completes, its future resolves, and all pool threads exit — no
        in-flight future is ever abandoned.  The executor stays visible
        while draining so in-flight ops that try to fan out degrade to
        inline execution (``run_tasks``) instead of erroring.  Abandoned
        hedge attempts (already timed out and failed over past) are the
        one exception: their threads are joined here too, after the round
        pool drains, so a sleeping slow replica can't leak a thread."""
        with self._pool_lock:
            self._closed = True
            pool = self._pool
            hedge = self._hedge_pool
        if pool is not None:
            pool.shutdown(wait=True)
            with self._pool_lock:
                self._pool = None
        if hedge is not None:
            hedge.shutdown(wait=True)
            with self._pool_lock:
                self._hedge_pool = None

    # ------------------------------------------------------------ execution
    def _execute(self, task: IoTask, fn: Callable[[IoTask], Any]) -> Any:
        prev = getattr(self._in_worker, "active", False)
        self._in_worker.active = True
        t0 = time.perf_counter()
        try:
            return fn(task)
        finally:
            self._in_worker.active = prev
            if task.kind in ("fetch", "store"):
                self.observe_round(task.server_id,
                                   time.perf_counter() - t0, task.nbytes)

    def run_tasks(self, tasks: Sequence[IoTask],
                  fn: Callable[[IoTask], Any]) -> List[Any]:
        """Execute a planned round set; returns results in task order.

        From the application thread, fan-out happens on the pool.  From a
        pool worker (an async op issuing its own rounds) a plain blocking
        fan-out is how shared-pool designs deadlock — every worker waiting
        on a queue only workers can drain — so workers use *help-drain*:
        submit every round, then walk them in order, CANCELLING any round
        no other worker has started yet and running it inline.  A started
        round is leaf work (it never re-enters this wait), so blocking on
        it is deadlock-free; a queued round is always cancellable.  Idle
        workers therefore still lend parallelism to an async op's rounds,
        and a saturated pool degrades to inline execution instead of
        deadlock.
        """
        if len(tasks) <= 1 or self._max_workers <= 1:
            return [self._execute(t, fn) for t in tasks]
        pool = self._pool_get()
        if not self.in_worker():
            return list(pool.map(lambda t: self._execute(t, fn), tasks))
        futs: List[Optional[Future]] = []
        try:
            for t in tasks:
                futs.append(pool.submit(self._execute, t, fn))
        except RuntimeError:
            # Pool draining for shutdown: the rounds run inline instead.
            futs.extend([None] * (len(tasks) - len(futs)))
        results: List[Any] = []
        try:
            for t, fut in zip(tasks, futs):
                if fut is None or fut.cancel():
                    results.append(self._execute(t, fn))
                else:
                    results.append(fut.result())
        except BaseException:
            for fut in futs:
                if fut is not None:
                    fut.cancel()
            raise
        return results

    def submit_op(self, fn: Callable[[], Any], stats=None) -> IoFuture:
        """Run a whole client op on the pool; returns its ``IoFuture``.

        The async surface's engine: the op body (plan + rounds + commit)
        executes on a worker, and the caller's thread is free to plan the
        next op.  ``stats`` is the owning client's ``ClientStats``
        (records ``blocked_waits`` when the caller has to block on the
        result).
        """
        task = IoTask("op")
        t0 = time.perf_counter()

        def body(_t):
            self._observe_op_wait(time.perf_counter() - t0)
            return fn()

        fut = self._pool_get().submit(self._execute, task, body)
        return IoFuture(fut, stats)

    def _observe_op_wait(self, seconds: float) -> None:
        with self._model_lock:
            self._ops_observed += 1
            prev = self._ewma_op_wait_s
            self._ewma_op_wait_s = (
                seconds if prev is None
                else prev + _EWMA_ALPHA * (seconds - prev))

    # ------------------------------------------------------- adaptive model
    def observe_round(self, server_id: Optional[int], seconds: float,
                      nbytes: int) -> None:
        """Feed one completed storage round into the EWMA cost model."""
        if seconds <= 0:
            return
        with self._model_lock:
            self._rounds_observed += 1
            if server_id is not None:
                prev = self._rtt_by_server.get(server_id)
                self._rtt_by_server[server_id] = (
                    seconds if prev is None
                    else prev + _EWMA_ALPHA * (seconds - prev))
            if nbytes <= _SMALL_ROUND_BYTES:
                prev = self._ewma_round_s
                self._ewma_round_s = (
                    seconds if prev is None
                    else prev + _EWMA_ALPHA * (seconds - prev))
            elif nbytes >= _LARGE_ROUND_BYTES:
                bw = nbytes / seconds
                prev = self._ewma_bw
                self._ewma_bw = (bw if prev is None
                                 else prev + _EWMA_ALPHA * (bw - prev))

    def _adaptive_bytes(self) -> int:
        with self._model_lock:
            if self._ewma_round_s is None or self._ewma_bw is None:
                return ADAPTIVE_SEED
            est = int(self._ewma_round_s * self._ewma_bw)
        return max(ADAPTIVE_FLOOR, min(ADAPTIVE_CEILING, est))

    def gap_bytes(self) -> int:
        """Read-side coalescing threshold: fetch-and-discard a gap of at
        most this many bytes rather than pay another round trip.  Pinned
        by the ``fetch_gap_bytes`` knob; otherwise one round-trip's worth
        of bytes under the current EWMA estimates."""
        if self._gap_override is not None:
            return self._gap_override
        return self._adaptive_bytes()

    def coalesce_bytes(self) -> int:
        """Write-side packing threshold (``store_coalesce_bytes`` pins)."""
        if self._coalesce_override is not None:
            return self._coalesce_override
        return self._adaptive_bytes()

    def readahead_bytes(self) -> int:
        """Server readahead window: how far past a sequential reader's
        last batch the storage server speculates.  A multiple of the
        round-trip-worth estimate so a stream absorbs several coalesced
        batches per speculative read, clamped to keep the per-server
        buffer pool bounded."""
        return max(READAHEAD_FLOOR,
                   min(READAHEAD_CEILING, 8 * self._adaptive_bytes()))

    def snapshot(self) -> dict:
        """Adaptive-threshold accounting for ``Cluster.total_stats``."""
        with self._model_lock:
            rtt = dict(self._rtt_by_server)
            round_s, bw = self._ewma_round_s, self._ewma_bw
            rounds = self._rounds_observed
            op_wait, ops = self._ewma_op_wait_s, self._ops_observed
        return {
            "ops_observed": ops,
            "ewma_op_wait_s": op_wait,
            "adaptive_gap_bytes": self.gap_bytes(),
            "adaptive_coalesce_bytes": self.coalesce_bytes(),
            "gap_pinned": self._gap_override is not None,
            "coalesce_pinned": self._coalesce_override is not None,
            "rounds_observed": rounds,
            "ewma_round_s": round_s,
            "ewma_bandwidth_bps": bw,
            "ewma_rtt_by_server": rtt,
        }
