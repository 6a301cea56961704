"""Sharded metadata plane: N independent WarpKV shards + cross-shard 2PC.

Every transaction used to funnel through ONE ``WarpKV`` — one commit mutex,
one WAL, one subscribe stream — the hard ceiling on metadata throughput no
matter how fast the single-store path is.  The WTF paper itself runs
against a HyperDex Warp *ensemble*, not a single node; this module is the
in-process stand-in for that ensemble.

``ShardedKV`` partitions the keyspace across ``n_shards`` full ``WarpKV``
instances, each keeping its own group commit, stripe locks, bounded WAL and
version-preserving compaction:

  * ``inodes`` and ``regions`` keys route by ``inode_id % n_shards`` — an
    inode and ALL its region metadata live on one shard;
  * everything else (``paths``, auxiliary spaces) routes by stable hash;
  * ``colocated_inode_id`` biases inode-id allocation so an inode lands on
    the same shard as its path, making the hot per-file transactions
    (open/read/write/append on one file) **single-shard by construction**.

Single-shard commits are handed verbatim to that shard's ``_commit`` — the
exact group-commit fast path, zero new overhead, no 2PC counters touched.

The rare transaction whose footprint spans shards (namespace ops touching a
parent directory on another shard, multi-file transactions) runs two-phase
commit, built from the shard-local hooks ``lock_keys`` /
``_validate_and_stage`` / ``_apply_staged``:

  prepare  — per touched shard, in ascending shard order: acquire that
             shard's stripe locks (canonical sorted order), validate read
             versions + commutative preconditions, stage results.  Any
             failure releases everything; no shard has been mutated, so
             nothing is ever visible (all-or-nothing trivially holds).
  decide   — the commit point.  A coordinator crash here resolves either
             way (``PhaseCrash``): "abort" rolls back exactly like a
             prepare failure; "commit" means the decision record survived,
             so the coordinator rolls FORWARD and applies everywhere.
  apply    — per shard, ``_apply_staged`` (cannot fail — everything was
             validated under locks that are still held).

Deadlock freedom: every committer — group-commit leaders within a shard and
2PC coordinators across shards — acquires stripes in the global
(shard index, stripe id) order.

``subscribe`` keeps the single totally-ordered event stream consumers
expect: each subscriber gets per-shard forwarders serialized through one
reentrant lock (replay shard 0..N-1, then live events in a total order that
preserves each shard's commit order), with per-shard sequence numbers
available via ``with_meta=True``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, List

from .errors import KVConflict
from .iort import AtomicStatsMixin
from .metadata import Transaction, WarpKV
from .placement import stable_hash
from .testing import witness_lock


class PhaseCrash(Exception):
    """Injected coordinator crash at the 2PC commit point (testing).

    ``resolution`` is what the recovery protocol would read back from the
    (modeled) decision record: "abort" → roll back everywhere, surface a
    retryable ``KVConflict``; "commit" → the decision was durable, roll
    forward and complete the commit as if nothing happened.
    """

    def __init__(self, resolution: str = "abort"):
        super().__init__(f"injected coordinator crash (resolution={resolution})")
        self.resolution = resolution


@dataclass(slots=True)
class MdShardStats(AtomicStatsMixin):
    """2PC coordinator counters (cluster-level, not per shard)."""

    single_shard_commits: int = 0    # routed straight to one shard
    cross_shard_commits: int = 0     # committed through 2PC
    prepare_aborts: int = 0          # 2PC aborted before the commit point
    recovered_commits: int = 0       # crash at decide resolved as commit
    _stats_lock: threading.Lock = field(default_factory=threading.Lock,
                                        repr=False, compare=False)


class _TxnPart:
    """One shard's slice of a cross-shard transaction — duck-typed to what
    ``WarpKV._validate_and_stage`` / ``_apply_staged`` read."""

    __slots__ = ("_reads", "_writes", "_commutes")

    def __init__(self):
        self._reads: dict = {}
        self._writes: dict = {}
        self._commutes: list = []

    def touched(self) -> set:
        t = set(self._reads) | set(self._writes)
        t.update((s, k) for s, k, _, _ in self._commutes)
        return t


class _AggKVStats:
    """Read-only aggregated view over every shard's ``KVStats`` so
    ``cluster.kv.stats.commits`` / ``.snapshot()`` keep working unchanged
    on a sharded cluster.  A cross-shard commit counts once per shard it
    applied on; per-shard truth is in ``ShardedKV.shards[i].stats``."""

    def __init__(self, shards: List[WarpKV]):
        self._shards = shards

    def snapshot(self) -> dict:
        out: dict = {}
        for sh in self._shards:
            for name, v in sh.stats.snapshot().items():
                out[name] = out.get(name, 0) + v
        return out

    def add(self, **counts) -> None:
        """Attribute the increment to shard 0 (callers that bump counters
        through the aggregate — e.g. FlakyKV's injected aborts — don't
        belong to any particular shard; sums stay correct)."""
        self._shards[0].stats.add(**counts)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return sum(getattr(sh.stats, name) for sh in self._shards)


class ShardedKV:
    """Drop-in ``WarpKV`` replacement routing over N real shards."""

    def __init__(self, n_shards: int, group_commit: bool = True,
                 service_time_s: float = 0.0):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = n_shards
        self.group_commit = group_commit
        self.shards: List[WarpKV] = [
            WarpKV(group_commit=group_commit, service_time_s=service_time_s,
                   shard_index=i)
            for i in range(n_shards)]
        self.stats_2pc = MdShardStats()
        self._fail_next_commits = 0

    # -- routing ------------------------------------------------------------
    def shard_index(self, space: str, key: Any) -> int:
        """Shard owning ``space:key``.  Inode-keyed spaces route by inode id
        so an inode and its regions are always colocated; other spaces by
        content-stable hash (deterministic across processes)."""
        if space == "inodes":
            return key % self.n_shards
        if space == "regions":
            return key[0] % self.n_shards
        return stable_hash(space, key, salt="mdshard") % self.n_shards

    def colocated_inode_id(self, path: str, raw_id: int) -> int:
        """Stretch a unique raw id onto the shard of ``path`` so the file's
        inode/regions join its path entry — the hot open/read/write
        transactions then touch exactly one shard."""
        return raw_id * self.n_shards + self.shard_index("paths", path)

    def _shard(self, space: str, key: Any) -> WarpKV:
        return self.shards[self.shard_index(space, key)]

    # -- WarpKV surface -----------------------------------------------------
    @property
    def stats(self) -> _AggKVStats:
        return _AggKVStats(self.shards)

    def _read_versioned(self, space: str, key: Any) -> tuple:
        return self._shard(space, key)._read_versioned(space, key)

    def get(self, space: str, key: Any, default: Any = None) -> Any:
        return self._shard(space, key).get(space, key, default)

    def put(self, space: str, key: Any, value: Any) -> None:
        txn = self.begin()
        txn.put(space, key, value)
        txn.commit()

    def keys(self, space: str) -> list:
        """Shard-aware walk: each shard's keys in shard order (the GC
        scanner's deterministic iteration across the whole plane)."""
        out: list = []
        for sh in self.shards:
            out.extend(sh.keys(space))
        return out

    def begin(self) -> Transaction:
        return Transaction(self)

    def add_invalidation_listener(self, fn: Callable[[list], None]) -> None:
        for sh in self.shards:
            sh.add_invalidation_listener(fn)

    def inject_aborts(self, n: int = 1) -> None:
        self._fail_next_commits = n

    # -- replication / subscribe fan-in -------------------------------------
    def subscribe(self, fn: Callable, with_meta: bool = False
                  ) -> Callable[[], None]:
        """Single totally-ordered stream over all shards.

        Replay delivers shard 0's compacted snapshot + tail, then shard
        1's, … — deterministic.  Live events from all shards serialize
        through one per-subscriber reentrant lock (reentrant because a
        listener may itself commit, re-entering the stream on the same
        thread), preserving each shard's commit order within the total
        order.  ``with_meta=True`` delivers ``fn(space, key, value,
        version, shard, seq)`` where ``seq`` is that shard's 1-based,
        gap-free sequence number for this subscriber.

        Returns a zero-argument cancel callable that detaches every
        per-shard forwarder (mirrors ``WarpKV.subscribe``).
        """
        sub_lock = witness_lock(threading.RLock(), "sub.fanin")
        seqs = [0] * self.n_shards

        def forwarder(i: int) -> Callable:
            def forward(space, key, value, version):
                with sub_lock:
                    seqs[i] += 1
                    if with_meta:
                        fn(space, key, value, version, i, seqs[i])
                    else:
                        fn(space, key, value, version)
            return forward

        cancels = [sh.subscribe(forwarder(i))
                   for i, sh in enumerate(self.shards)]

        def cancel() -> None:
            for c in cancels:
                c()

        return cancel

    def wal_entries(self) -> int:
        return sum(sh.wal_entries() for sh in self.shards)

    # -- commit routing -----------------------------------------------------
    def _commit(self, txn) -> None:
        if self._fail_next_commits > 0:
            self._fail_next_commits -= 1
            self.shards[0].stats.add(aborts=1)
            raise KVConflict("injected abort")
        touched_shards: set[int] = set()
        for space, key in txn._reads:
            touched_shards.add(self.shard_index(space, key))
        for space, key in txn._writes:
            touched_shards.add(self.shard_index(space, key))
        for space, key, _, _ in txn._commutes:
            touched_shards.add(self.shard_index(space, key))
        if len(touched_shards) <= 1:
            # The PR 5 fast path, verbatim: group commit, stripe locks,
            # leader/follower batching — all inside the owning shard.
            idx = touched_shards.pop() if touched_shards else 0
            self.stats_2pc.add(single_shard_commits=1)
            self.shards[idx]._commit(txn)
            return
        self._commit_cross(txn, touched_shards)

    def _commit_cross(self, txn, touched_shards: set[int]) -> None:
        """Two-phase commit across ``touched_shards`` (ascending order)."""
        parts: dict[int, _TxnPart] = {i: _TxnPart()
                                      for i in sorted(touched_shards)}
        for sk, ver in txn._reads.items():
            parts[self.shard_index(*sk)]._reads[sk] = ver
        for sk, val in txn._writes.items():
            parts[self.shard_index(*sk)]._writes[sk] = val
        for entry in txn._commutes:
            parts[self.shard_index(entry[0], entry[1])]._commutes.append(
                entry)
        hook = getattr(txn, "_phase_hook", None)

        held: list[tuple[WarpKV, list]] = []
        staged_all: list[tuple[WarpKV, _TxnPart, list]] = []
        try:
            try:
                pos = 0
                for idx in sorted(parts):
                    pos += 1
                    if hook is not None:
                        hook("prepare", pos)
                    shard = self.shards[idx]
                    part = parts[idx]
                    shard._service_delay()      # prepare round trip
                    held.append((shard, shard.lock_keys(part.touched())))
                    staged_all.append(
                        (shard, part, shard._validate_and_stage(part)))
                if hook is not None:
                    hook("decide", 0)           # the commit point
            except PhaseCrash as crash:
                if crash.resolution == "commit" \
                        and len(staged_all) == len(parts):
                    # Decision record survived the crash: roll forward.
                    self._apply_all(staged_all)
                    self.stats_2pc.add(cross_shard_commits=1,
                                       recovered_commits=1)
                    return
                self.stats_2pc.add(prepare_aborts=1)
                raise KVConflict(
                    "2PC coordinator crashed before commit decision; "
                    "resolved as abort") from crash
            except BaseException:
                # Prepare failed on some shard: nothing was applied
                # anywhere, so releasing the locks IS the rollback.
                self.stats_2pc.add(prepare_aborts=1)
                raise
            self._apply_all(staged_all)
            self.stats_2pc.add(cross_shard_commits=1)
        finally:
            for shard, stripe_ids in reversed(held):
                shard.unlock_keys(stripe_ids)

    def _apply_all(self, staged_all) -> None:
        for shard, part, staged in staged_all:
            shard._service_delay()              # apply round trip
            shard._apply_staged(part, staged)
