"""WarpKV — the transactional metadata store (HyperDex/Warp stand-in).

The paper stores all filesystem metadata in HyperDex and relies on three
properties of its transactions [15]:

  1. linearizable multi-key transactions across independent schemas ("spaces"),
  2. optimistic concurrency: a transaction aborts iff a value it *read*
     changed before commit,
  3. atomic list append that does not create a read dependency — this is what
     lets concurrent writers append slice pointers to the same region without
     conflicting (§2.1, §2.5).

WarpKV reproduces exactly that contract in-process:

  * every key is versioned; ``get`` inside a transaction records the version,
  * ``put``/``delete`` are buffered and applied atomically at commit,
  * *commutative operations* (``CommutingOp``) are evaluated at commit time
    under the commit locks, with a precondition check instead of a read
    dependency.  They model HyperDex's atomic append and the paper's bounded
    relative append (§2.5).  A commutative op that leaves the value unchanged
    does not bump the version, so e.g. parallel appends into the same region
    do not invalidate each other's inode reads.

Commit protocol: stripe locks are acquired in canonical order (no deadlock),
read versions validated, preconditions checked, writes applied, versions
bumped.  This yields strict serializability for the in-process setting.

**Group commit.**  Under concurrent auto-commit traffic the stripe-lock
acquisition pass itself becomes the convoy: every committer sorts and takes
its stripe locks one at a time while the rest pile up behind them.  With
``group_commit`` (default on), committers enqueue and the first one through
the commit mutex drains the queue as the *leader*: one sorted acquisition
pass over the union of the batch's stripes, then each transaction's
validate/stage/apply runs sequentially under those locks.  Sequential
application preserves the exact single-commit semantics (a batch-mate that
invalidates your read set aborts you precisely as a prior commit would
have), and failures are isolated per transaction.  ``KVStats`` records
``commit_lock_passes`` (sorted acquisition passes actually made) and
``grouped_commits`` (transactions that rode a leader's pass) — the
measurable win.

**Version-preserving commutes.**  A commutative op may declare
``version_preserving = True`` (see ``inode.CompactRegion``): when its
commit-time application changes the stored value while provably preserving
the bytes any reader can observe, WarpKV keeps the key's version unchanged.
Readers' recorded versions — and the plan cache validated against them —
stay valid; a metadata-shape-only rewrite never aborts anyone.

A bounded write-ahead log of committed mutations supports replication
veneers: a compacted latest-value-per-key snapshot plus a tail ring of the
most recent ``WAL_TAIL_MAX`` mutations, so a long-running cluster's WAL
memory is O(keyspace + tail), not O(history).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, List, Optional

from .errors import KVConflict, PreconditionFailed
from .iort import AtomicStatsMixin
from .testing import witness_lock

_TOMBSTONE = object()


@dataclass(slots=True)
class _Versioned:
    version: int
    value: Any


class CommutingOp:
    """A read-free, commit-time read-modify-write (HyperDex atomic append).

    ``apply(value)`` returns ``(new_value, result)``; it runs under the commit
    locks against the *latest* committed value.  ``precondition(value)`` may
    veto at commit time (→ ``PreconditionFailed``, the transaction as a whole
    aborts and the WTF retry layer takes over).  Ops must be pure so commit
    retries/replays are safe.

    ``version_preserving = True`` declares that this op's value changes
    preserve every byte a reader can observe (e.g. region compaction):
    WarpKV then applies the change WITHOUT bumping the key's version, so
    recorded read dependencies and version-validated plan caches survive.
    Only set it when that property genuinely holds — a version-preserving
    op that changes observable content would break serializability.

    ``preserves_version(old, new)`` refines the class-level flag per
    application: an op whose effect is *sometimes* invisible to
    serializability (e.g. ``BumpInode`` advancing only ``mtime``) can
    keep the version for exactly those applications.
    """

    version_preserving = False
    __slots__ = ()

    def precondition(self, value: Any) -> bool:  # pragma: no cover - default
        return True

    def apply(self, value: Any):  # -> tuple[Any, Any]
        raise NotImplementedError

    def preserves_version(self, old: Any, new: Any) -> bool:
        """Whether replacing ``old`` with ``new`` may keep the version.
        Called under the commit locks, after ``apply``; default is the
        class-level declaration."""
        return self.version_preserving


class ListAppend(CommutingOp):
    """Generic atomic list append (the HyperDex primitive WTF relies on)."""

    __slots__ = ("items",)

    def __init__(self, items: Iterable[Any]):
        self.items = list(items)

    def apply(self, value):
        cur = list(value) if value is not None else []
        cur.extend(self.items)
        return cur, len(cur)


class Transaction:
    """One optimistic multi-key transaction.

    When a lease table is attached (``attach_leases``), reads are served
    from valid client-side leases without touching the KV, and a read-only
    transaction whose every read dependency is covered by a still-valid
    lease commits without any KV round trip at all (``commit`` revalidates
    the leases and skips ``_commit`` entirely).  A revoked or expired lease
    simply falls back to the normal path: the recorded read versions are
    validated by the KV at commit, so a stale lease can never produce a
    stale commit — it produces a ``KVConflict`` and a §2.6 replay.
    """

    __slots__ = ("_kv", "_reads", "_writes", "_commutes",
                 "_commutes_by_key", "committed",
                 "_lease_tab", "_lease_used", "_phase_hook")

    def __init__(self, kv: "WarpKV"):
        self._kv = kv
        self._reads: dict[tuple[str, Any], int] = {}
        self._writes: dict[tuple[str, Any], Any] = {}
        self._commutes: list[tuple[str, Any, CommutingOp, list]] = []
        # per-key index so read-your-writes views don't scan the whole
        # queue (bulk paste/concat transactions queue thousands of ops)
        self._commutes_by_key: dict[tuple[str, Any], list] = {}
        self.committed = False
        self._lease_tab = None            # lease.LeaseTable, duck-typed
        self._lease_used: dict[tuple[str, Any], int] = {}
        self._phase_hook = None           # 2PC fault injection (testing)

    def attach_leases(self, table) -> None:
        """Serve this transaction's reads through a client lease table."""
        self._lease_tab = table

    def _read_dep(self, space: str, key: Any) -> tuple[int, Any]:
        """Committed (version, value) for a read dependency: from a valid
        lease when one is held (zero KV round trips), else from the KV —
        granting a lease on the way out so the *next* transaction hits."""
        sk = (space, key)
        tab = self._lease_tab
        if tab is not None:
            hit = tab.lookup(sk)
            if hit is not None:
                self._lease_used[sk] = hit[0]
                return hit
            tok = tab.begin_grant(sk)
            ver, val = self._kv._read_versioned(space, key)
            if tab.commit_grant(sk, tok, ver, val):
                self._lease_used[sk] = ver
            return ver, val
        return self._kv._read_versioned(space, key)

    # -- read set -----------------------------------------------------------
    def get(self, space: str, key: Any, default: Any = None) -> Any:
        sk = (space, key)
        if sk in self._writes:
            v = self._writes[sk]
            return default if v is _TOMBSTONE else v
        ver, val = self._read_dep(space, key)
        # Record the *first* observed version; seeing a different version on
        # a later read of the same key inside one txn is itself a conflict.
        prev = self._reads.setdefault(sk, ver)
        if prev != ver:
            raise KVConflict(f"non-repeatable read of {space}:{key!r}")
        return default if val is None else val

    def get_version(self, space: str, key: Any) -> Optional[int]:
        """Observed version of ``space:key``, with the read dependency
        recorded exactly like ``get`` — the plan cache's validation
        primitive: a cached plan whose regions still carry their recorded
        versions is as serializable as a fresh plan, because this call
        pins the same versions a re-plan would read.  Returns ``None`` for
        a key this transaction has buffered writes for (no stable
        committed version exists)."""
        sk = (space, key)
        if sk in self._writes:
            return None
        ver, _ = self._read_dep(space, key)
        prev = self._reads.setdefault(sk, ver)
        if prev != ver:
            raise KVConflict(f"non-repeatable read of {space}:{key!r}")
        return ver

    # -- write set ----------------------------------------------------------
    def put(self, space: str, key: Any, value: Any) -> None:
        self._writes[(space, key)] = value

    def delete(self, space: str, key: Any) -> None:
        self._writes[(space, key)] = _TOMBSTONE

    # -- commutative ops ----------------------------------------------------
    def commute(self, space: str, key: Any, op: CommutingOp) -> "_Deferred":
        """Queue a commit-time op; returns a cell filled in at commit."""
        sk = (space, key)
        per_key = self._commutes_by_key.setdefault(sk, [])
        # coalesce with the previous queued op on the same key when the op
        # type supports it (append-of-append, bump-of-bump): a bulk paste
        # queues thousands of ops on a handful of keys, and both the
        # read-your-writes view and commit apply then stay O(keys)
        if per_key and type(per_key[-1][2]) is type(op) \
                and hasattr(op, "coalesce"):
            entry = per_key[-1]
            merged = entry[2].coalesce(op)
            if merged is not None:
                entry[2] = merged
                return _Deferred(entry[3])
        entry = [space, key, op, []]
        self._commutes.append(entry)
        per_key.append(entry)
        return _Deferred(entry[3])

    def map_commutes(self, fn: Callable[[CommutingOp],
                                        Optional[CommutingOp]]) -> None:
        """Rewrite queued commutative ops in place: ``fn(op)`` returns a
        replacement op (or None / the same op to keep it).  Deferred result
        cells and queue order are preserved.  Used by the write-behind
        buffer to swap pending slice pointers for real ones after its
        commit-time flush, before this transaction commits."""
        for entry in self._commutes:
            new = fn(entry[2])
            if new is not None and new is not entry[2]:
                entry[2] = new

    def get_view(self, space: str, key: Any, default: Any = None) -> Any:
        """Read-your-writes view: the committed value (read dependency is
        recorded) with this transaction's queued commutative ops applied.

        If a concurrent transaction changes the key between this read and
        our commit, the read-version validation aborts us and the WTF retry
        layer replays — so the view the application saw is always consistent
        with what commits.
        """
        val = self.get(space, key, None)
        return self._apply_queued(space, key, val, default)

    def peek(self, space: str, key: Any, default: Any = None) -> Any:
        """Unvalidated snapshot read: like ``get_view`` but records NO read
        dependency.  Used where staleness is guarded by a commit-time
        precondition instead — e.g. the bounded relative append's fit check
        (§2.5), which must not make concurrent appends conflict."""
        sk = (space, key)
        if sk in self._writes:
            v = self._writes[sk]
            val = None if v is _TOMBSTONE else v
        else:
            tab = self._lease_tab
            hit = tab.lookup(sk) if tab is not None else None
            if hit is not None:
                val = hit[1]       # lease-served snapshot; no dep recorded
            else:
                _, val = self._kv._read_versioned(space, key)
        return self._apply_queued(space, key, val, default)

    def _apply_queued(self, space: str, key: Any, val: Any,
                      default: Any) -> Any:
        for entry in self._commutes_by_key.get((space, key), ()):
            val, _ = entry[2].apply(val)
        return default if val is None else val

    # -- commit -------------------------------------------------------------
    def commit(self) -> None:
        if self._lease_commit_skip():
            self.committed = True
            return
        self._kv._commit(self)
        self.committed = True

    def _lease_commit_skip(self) -> bool:
        """True iff this txn is read-only, every read dependency was served
        or covered by a lease, and all those leases revalidate atomically at
        their recorded versions right now — in which case committing at the
        KV would be a pure no-op validation pass, so we skip it entirely.
        Revalidation failing is NOT an abort: we fall through to the normal
        KV commit, which re-validates against real versions (and conflicts
        only if the data truly moved, not merely because a lease expired)."""
        tab = self._lease_tab
        if tab is None or self._writes or self._commutes or not self._reads:
            return False
        if len(self._lease_used) != len(self._reads):
            return False              # some read dep isn't lease-covered
        return tab.revalidate(self._lease_used)

    def abort(self) -> None:
        self._reads.clear()
        self._writes.clear()
        self._commutes.clear()
        self._commutes_by_key.clear()
        self._lease_used.clear()


class _Deferred:
    """Result of a commutative op, available after commit."""

    __slots__ = ("_cell",)

    def __init__(self, cell: list):
        self._cell = cell

    @property
    def value(self) -> Any:
        if not self._cell:
            raise RuntimeError("deferred result read before commit")
        return self._cell[0]


@dataclass(slots=True)
class KVStats(AtomicStatsMixin):
    """Counters bumped from the app thread AND runtime pool workers (async
    op bodies run their own KV transactions); mutation goes through the
    atomic ``add`` like the client/storage stats.

    ``commit_lock_passes`` counts sorted stripe-lock acquisition passes
    actually made; with group commit, concurrently-arriving transactions
    share a pass, so ``commits - commit_lock_passes`` (≈ ``grouped_commits``)
    is the number of acquisition passes the batching saved.
    ``compactions`` counts version-preserving commutes that actually
    rewrote a value (commit-time region compactions applied).

    ``conflicts`` counts true optimistic-concurrency losses — a commit
    aborted because a *read version* moved underneath it.  It is a strict
    subset of ``aborts``: precondition failures (e.g. a bounded append
    hitting a region boundary) and injected aborts are part of their
    protocols, not contention, and only bump ``aborts``.  §2.5's claim is
    exactly "parallel appends never conflict", i.e. ``conflicts == 0``.

    ``commit_wait_s`` / ``commit_hold_s`` / ``leader_drains`` expose the
    group-commit admission queue: wall-seconds committers spent waiting
    for a batch outcome, wall-seconds leaders spent draining batches, and
    the number of batches drained.  If commits serialize, waits grow with
    committer count while holds stay flat — that asymmetry is how the
    append serialization point was localized.
    """

    commits: int = 0
    aborts: int = 0
    conflicts: int = 0               # read-version validation failures
    gets: int = 0
    puts: int = 0
    commutes: int = 0
    compactions: int = 0             # version-preserving rewrites applied
    commit_lock_passes: int = 0      # stripe-lock acquisition passes made
    grouped_commits: int = 0         # txns that shared a leader's pass
    leader_drains: int = 0           # group-commit batches drained
    commit_wait_s: float = 0.0       # committer time queued for an outcome
    commit_hold_s: float = 0.0       # leader time spent draining batches
    _stats_lock: threading.Lock = field(default_factory=threading.Lock,
                                        repr=False, compare=False)


class _CommitReq:
    """One queued commit: its transaction, outcome slot, and wakeup event.

    ``done``/``exc`` are written by the batch leader before it sets
    ``evt``; the owner reads them after ``evt.wait()`` returns — the
    event is the memory barrier.  ``lead`` is written only under the
    commit-queue lock (at enqueue, or by the previous leader handing
    off) and read by the owner after the same lock or event."""

    __slots__ = ("txn", "exc", "done", "evt", "lead")

    def __init__(self, txn: Transaction):
        self.txn = txn
        self.exc: Optional[BaseException] = None
        self.done = False
        self.evt = threading.Event()
        self.lead = False


class WarpKV:
    """Striped, versioned, optimistically-concurrent in-process KV store."""

    N_STRIPES = 64
    # WAL tail ring capacity: older mutations fold into the compacted
    # latest-value-per-key snapshot (see the module docstring).
    WAL_TAIL_MAX = 4096

    def __init__(self, group_commit: bool = True,
                 service_time_s: float = 0.0,
                 shard_index: int = 0):
        # ``shard_index`` places this store in the global (shard, stripe)
        # acquisition order; ``mdshard.ShardedKV`` passes each shard's
        # position.  Locks are wrapped by the runtime lock-order witness
        # when WTF_LOCK_WITNESS is set (no-op passthrough otherwise).
        self.shard_index = shard_index
        self._spaces: dict[str, dict[Any, _Versioned]] = {}
        self._space_lock = witness_lock(threading.Lock(), "kv.space")
        self._stripes = [
            witness_lock(threading.RLock(), "kv.stripe",
                         key=(shard_index, i))
            for i in range(self.N_STRIPES)]
        self.stats = KVStats()
        self.group_commit = group_commit
        # Modeled per-request service time of ONE metadata server: each
        # read and each commit pass serializes on a single service lock
        # while sleeping (GIL released), so a store has bounded capacity
        # and shard counts / lease hit rates become physically measurable.
        # 0.0 (the default) adds zero overhead on every path.
        self._service_time = float(service_time_s)
        self._service_lock = witness_lock(threading.Lock(), "kv.service")
        # Pre-apply lease barrier: called with the keys a commit is about
        # to mutate, under the stripe locks, BEFORE the first store — so a
        # lease holder that revalidates successfully is guaranteed not to
        # have observed any part of an in-flight commit (see core/lease.py).
        self._inval_listeners: list[Callable[[list], None]] = []
        self._commit_queue: List[_CommitReq] = []
        self._commit_queue_lock = witness_lock(threading.Lock(),
                                               "kv.commit_queue")
        # True while some committer owns batch leadership.  Leadership is
        # granted at enqueue (queue empty, no leader) or handed off by the
        # retiring leader to the head of the queue — always under
        # ``_commit_queue_lock``, so there is at most one leader and the
        # flag can never be left set without a live owner.
        self._leader_active = False
        self._leader_thread: Optional[int] = None
        # Bounded write-ahead log of committed mutations for chain
        # replication: compacted snapshot + recent-mutation tail ring.
        self._wal_tail: "deque[tuple[str, Any, Any, int]]" = deque()
        self._wal_snapshot: dict[tuple[str, Any], tuple[Any, int]] = {}
        # RLock: listeners run under this lock, and a listener that
        # commits re-enters ``_log`` on the same thread (the reentrant
        # commit path the ``_leader_thread`` guard permits).
        self._wal_lock = witness_lock(threading.RLock(), "kv.wal",
                                      key=shard_index)
        self._wal_listeners: list[Callable[[str, Any, Any, int], None]] = []
        self._fail_next_commits = 0   # test hook: forced HyperDex-level abort

    # -- plumbing -----------------------------------------------------------
    def _space(self, name: str) -> dict[Any, _Versioned]:
        sp = self._spaces.get(name)
        if sp is None:
            with self._space_lock:
                sp = self._spaces.setdefault(name, {})
        return sp

    def _stripe_of(self, space: str, key: Any) -> int:
        return hash((space, key)) % self.N_STRIPES

    def _service_delay(self) -> None:
        """One modeled server round trip (no-op when service time is 0)."""
        if self._service_time:
            with self._service_lock:
                # wtf-lint: ignore[WTF002] -- modeled service time: serializing the sleep IS the single-server queueing model
                time.sleep(self._service_time)

    def _read_versioned(self, space: str, key: Any) -> tuple[int, Any]:
        self._service_delay()
        self.stats.add(gets=1)
        sp = self._space(space)
        with self._stripes[self._stripe_of(space, key)]:
            ent = sp.get(key)
            if ent is None:
                return 0, None
            return ent.version, ent.value

    # -- non-transactional convenience (single-key linearizable ops) --------
    def get(self, space: str, key: Any, default: Any = None) -> Any:
        _, val = self._read_versioned(space, key)
        return default if val is None else val

    def put(self, space: str, key: Any, value: Any) -> None:
        txn = self.begin()
        txn.put(space, key, value)
        txn.commit()

    def keys(self, space: str) -> list:
        sp = self._space(space)
        # Snapshot under all stripe locks is unnecessary for iteration used
        # by the GC scanner; dict views are safe to copy in CPython.
        return [k for k, v in list(sp.items()) if v.value is not None]

    # -- transactions -------------------------------------------------------
    def begin(self) -> Transaction:
        return Transaction(self)

    def _commit(self, txn: Transaction) -> None:
        req = _CommitReq(txn)
        if not self.group_commit \
                or self._leader_thread == threading.get_ident():
            # Group commit off — or a re-entrant commit from inside a
            # batch (a WAL listener committing): parking on the admission
            # queue would deadlock against ourselves (we ARE the leader),
            # and the stripe RLocks are reentrant, so commit directly.
            self._commit_batch([req])
            if req.exc is not None:
                raise req.exc
            return
        # Group commit with leader *handoff*: enqueue; if nobody is
        # leading, lead immediately, otherwise park on our own event.
        # A leader drains exactly one batch under ONE sorted stripe-lock
        # acquisition pass, then passes leadership to the head of the
        # queue (a committer that arrived while it worked) and wakes its
        # own followers.  Unlike the old global commit mutex, retired
        # followers never re-acquire anything — they wake and return —
        # and the next batch's leader starts without waiting for this
        # batch's followers to drain through a mutex convoy.
        t0 = time.perf_counter()
        with self._commit_queue_lock:
            self._commit_queue.append(req)
            if not self._leader_active:
                self._leader_active = True
                req.lead = True
        if not req.lead:
            req.evt.wait()
        if req.lead:
            with self._commit_queue_lock:
                batch = self._commit_queue
                self._commit_queue = []
            self.stats.add(leader_drains=1,
                           commit_wait_s=time.perf_counter() - t0)
            t1 = time.perf_counter()
            self._leader_thread = threading.get_ident()
            try:
                self._commit_batch(batch)
            finally:
                self._leader_thread = None
                self.stats.add(commit_hold_s=time.perf_counter() - t1)
                with self._commit_queue_lock:
                    if self._commit_queue:
                        nxt = self._commit_queue[0]
                        nxt.lead = True
                        nxt.evt.set()
                    else:
                        self._leader_active = False
                for r in batch:
                    if r is not req:
                        r.evt.set()
        else:
            self.stats.add(commit_wait_s=time.perf_counter() - t0)
        if req.exc is not None:
            raise req.exc

    def _commit_batch(self, reqs: List[_CommitReq]) -> None:
        """Commit a batch under one stripe-lock pass (union of all stripes).

        Transactions are validated and applied *sequentially*, so the
        outcome is identical to committing them back-to-back: a batch-mate
        that invalidates your read set aborts you exactly as a prior
        commit would have.  Failures are isolated per transaction — each
        request carries its own exception back to its waiting committer.
        """
        self._service_delay()        # one modeled round trip per pass
        touched: set[tuple[str, Any]] = set()
        for req in reqs:
            t = req.txn
            touched |= set(t._reads) | set(t._writes)
            touched |= {(s, k) for s, k, _, _ in t._commutes}
        stripe_ids = sorted({self._stripe_of(s, k) for s, k in touched})
        self.stats.add(commit_lock_passes=1,
                       grouped_commits=len(reqs) - 1)
        for sid in stripe_ids:
            self._stripes[sid].acquire()
        try:
            for req in reqs:
                try:
                    self._apply_txn_locked(req.txn)
                except Exception as e:
                    req.exc = e
                finally:
                    req.done = True
        finally:
            for sid in reversed(stripe_ids):
                self._stripes[sid].release()
            for req in reqs:         # a leader crash must strand no one
                if not req.done:
                    req.exc = KVConflict("commit batch aborted")
                    req.done = True

    def _apply_txn_locked(self, txn: Transaction) -> None:
        """Validate and apply one transaction; caller holds its stripes."""
        self._apply_staged(txn, self._validate_and_stage(txn))

    def _validate_and_stage(self, txn) -> list:
        """Prepare phase: validate read versions and commutative
        preconditions, compute commute results against the post-write view
        — WITHOUT mutating anything.  Caller holds this shard's stripes
        for every touched key.  Raises on conflict; on success the returned
        staged list can be applied with ``_apply_staged`` (which cannot
        fail), so validate-everywhere-then-apply-everywhere is exactly the
        2PC contract ``mdshard.ShardedKV`` needs.  ``txn`` is duck-typed:
        anything carrying ``_reads``/``_writes``/``_commutes``."""
        if self._fail_next_commits > 0:
            # wtf-lint: ignore[WTF003] -- test-only crash hook; every caller holds the commit stripe locks
            self._fail_next_commits -= 1
            self.stats.add(aborts=1)
            raise KVConflict("injected abort")
        # 1. validate read versions (optimistic concurrency control)
        for (space, key), seen in txn._reads.items():
            ent = self._space(space).get(key)
            cur = ent.version if ent is not None else 0
            if cur != seen:
                self.stats.add(aborts=1, conflicts=1)
                raise KVConflict(
                    f"version conflict on {space}:{key!r} "
                    f"(saw {seen}, now {cur})")
        # 2. check commutative preconditions + compute results against
        # the post-write view (this txn's buffered writes included, and
        # earlier commutes on the same key chained in queue order)
        view: dict[tuple[str, Any], Any] = {}
        for (space, key), value in txn._writes.items():
            view[(space, key)] = None if value is _TOMBSTONE else value
        staged: list[tuple[str, Any, Any, Any, CommutingOp, list]] = []
        for space, key, op, cell in txn._commutes:
            sk = (space, key)
            if sk in view:
                cur = view[sk]
            else:
                ent = self._space(space).get(key)
                cur = ent.value if ent is not None else None
            if not op.precondition(cur):
                self.stats.add(aborts=1)
                raise PreconditionFailed(
                    f"precondition failed on {space}:{key!r}")
            new, result = op.apply(cur)
            view[sk] = new
            staged.append((space, key, new, result, op, cell))
        return staged

    def _apply_staged(self, txn, staged: list) -> None:
        """Apply phase: make a validated transaction's effects visible.
        Caller holds the stripes; this cannot fail (all validation already
        happened in ``_validate_and_stage``)."""
        # Lease barrier first: revoke leases on every key about to change
        # BEFORE any store, so no lease can outlive the pre-commit value
        # while part of this commit is already visible.
        if self._inval_listeners:
            changing = list(txn._writes)
            for space, key, new, _result, _op, _cell in staged:
                ent = self._space(space).get(key)
                if ent is None or ent.value != new:
                    changing.append((space, key))
            if changing:
                for fn in self._inval_listeners:
                    fn(changing)
        # 3. apply buffered writes.  Deletes keep a versioned tombstone
        # (value None) so a delete+recreate can never satisfy a stale
        # reader's version check (no ABA).
        n_compactions = 0
        for (space, key), value in txn._writes.items():
            sp = self._space(space)
            ent = sp.get(key)
            ver = (ent.version if ent is not None else 0) + 1
            stored = None if value is _TOMBSTONE else value
            sp[key] = _Versioned(ver, stored)
            self._log(space, key, stored, ver)
        # 4. apply commutative results; bump version only on real change,
        # and not at all for a version-preserving rewrite (compaction):
        # the bytes any reader can observe are unchanged, so recorded
        # read dependencies and cached plans must stay valid.
        for space, key, new, result, op, cell in staged:
            sp = self._space(space)
            ent = sp.get(key)
            if ent is not None and ent.value == new:
                pass                      # no-op merge: no invalidation
            elif ent is not None and op.preserves_version(ent.value, new):
                sp[key] = _Versioned(ent.version, new)
                self._log(space, key, new, ent.version)
                if op.version_preserving:
                    n_compactions += 1
            else:
                ver = (ent.version if ent is not None else 0) + 1
                sp[key] = _Versioned(ver, new)
                self._log(space, key, new, ver)
            cell.append(result)
        # One atomic bump for the whole transaction: each ``add`` takes
        # the stats lock, and per-key bumps were a measurable slice of
        # GIL-held commit time under many appenders.
        self.stats.add(commits=1, puts=len(txn._writes),
                       commutes=len(staged), compactions=n_compactions)

    # -- shard hooks (used by mdshard.ShardedKV) ----------------------------
    def lock_keys(self, touched: Iterable[tuple]) -> list[int]:
        """Acquire the stripe locks covering ``touched`` in canonical
        (sorted) order and return the stripe ids for ``unlock_keys``."""
        stripe_ids = sorted({self._stripe_of(s, k) for s, k in touched})
        for sid in stripe_ids:
            self._stripes[sid].acquire()
        return stripe_ids

    def unlock_keys(self, stripe_ids: list[int]) -> None:
        for sid in reversed(stripe_ids):
            self._stripes[sid].release()

    def add_invalidation_listener(self, fn: Callable[[list], None]) -> None:
        """Register a pre-apply lease barrier: ``fn(keys)`` is called under
        the commit's stripe locks with every (space, key) about to change,
        before the first store (see ``_apply_staged``)."""
        self._inval_listeners.append(fn)

    def colocated_inode_id(self, path: str, raw_id: int) -> int:
        """Map a unique raw inode id to the id actually stored.  A single
        shard has no placement constraint, so this is the identity; the
        sharded KV overrides it to colocate an inode with its path."""
        return raw_id

    # -- replication hooks ---------------------------------------------------
    def _log(self, space: str, key: Any, value: Any, version: int) -> None:
        with self._wal_lock:
            self._wal_tail.append((space, key, value, version))
            while len(self._wal_tail) > self.WAL_TAIL_MAX:
                s, k, v, ver = self._wal_tail.popleft()
                self._wal_snapshot[(s, k)] = (v, ver)
            for fn in self._wal_listeners:
                fn(space, key, value, version)

    def subscribe(self, fn: Callable, with_meta: bool = False) -> Callable[[], None]:
        """Replay the WAL into ``fn`` and register it for future commits.

        Replay is the compacted snapshot (latest folded value per key)
        followed by the tail ring, so a late subscriber converges on the
        exact current state in O(keyspace + tail) calls — not O(history).

        Replay and registration happen atomically under ``_wal_lock`` —
        the same lock every committer's ``_log`` takes — so there is no
        window between snapshot replay and live-tail attach: a mutation
        committing concurrently either lands in the replayed tail or is
        delivered live after registration, never both, never neither.

        ``with_meta=True`` delivers ``fn(space, key, value, version,
        shard, seq)`` with ``shard == 0`` and a per-subscriber 1-based
        gap-free ``seq`` — the same contract as ``ShardedKV.subscribe``,
        so stream consumers are agnostic to the shard count.

        Returns a zero-argument cancel callable that detaches the
        subscription (no further deliveries once it returns).
        """
        if with_meta:
            raw, box = fn, [0]

            def fn(space, key, value, version):  # noqa: F811
                box[0] += 1
                raw(space, key, value, version, 0, box[0])

        with self._wal_lock:
            for (space, key), (value, version) in self._wal_snapshot.items():
                fn(space, key, value, version)
            for space, key, value, version in self._wal_tail:
                fn(space, key, value, version)
            self._wal_listeners.append(fn)

        def cancel() -> None:
            with self._wal_lock:
                if fn in self._wal_listeners:
                    self._wal_listeners.remove(fn)

        return cancel

    def wal_entries(self) -> int:
        """Retained WAL size (snapshot keys + tail ring), for tests."""
        with self._wal_lock:
            return len(self._wal_snapshot) + len(self._wal_tail)

    # -- test hooks -----------------------------------------------------------
    def inject_aborts(self, n: int = 1) -> None:
        """Force the next ``n`` commits to abort at the KV level (for
        exercising the §2.6 retry layer)."""
        self._fail_next_commits = n
