"""Leased client-side metadata caching (FaaSFS-style, arXiv 2009.09845).

The WTF client's hot metadata reads — path lookups, inode fetches, region
version checks for the plan cache — are exactly the traffic that makes an
"idle-hot" client keep round-tripping to the metadata store.  This module
lets clients hold *leases* on recently-read keys:

  * ``LeaseTable`` — one per client.  A lease caches ``(version, value)``
    for a ``(space, key)`` pair, bounded in time (the cluster's
    ``lease_ttl``) and in version (any committed change revokes it).
    ``Transaction`` serves reads from valid leases with zero KV round
    trips, and a read-only transaction whose whole read set is
    lease-covered *commits* without touching the KV: it revalidates its
    leases atomically against the table and skips ``_commit`` entirely.

  * ``LeaseHub`` — one per cluster.  It wires revocation: a pre-apply
    **invalidation barrier** registered on every shard fires under the
    commit's stripe locks, before the first store, killing leases (and
    in-flight grants) for every key about to change; the per-shard WAL
    subscribe stream additionally piggybacks shared-plan-cache eviction,
    dropping cached I/O plans for any inode whose region metadata moved.

Why the barrier must run *before* the stores: suppose writer W commits
{A=a2, B=b2} and reader R holds leases {A@a1, B@b1}.  If revocation trailed
the stores, R could read B=b2 fresh (store visible) while its lease on A
still looked valid — revalidation would pass and R would commit the
non-serializable snapshot {a1, b2}.  With the barrier, both leases are dead
before *either* store is visible, so a successful revalidation proves R
observed no part of any in-flight commit.  The companion race — a lease
*granted* from a read that predates W but installed after W's barrier — is
closed by the two-step grant protocol: ``begin_grant`` installs a pending
placeholder **before** the KV read, the barrier kills placeholders too, and
``commit_grant`` refuses to activate a killed placeholder.

A revoked or expired lease is never an error: reads fall back to the KV,
and commit revalidation failure falls back to the normal optimistic commit
(which conflicts only if a version truly moved).  Staleness therefore
surfaces as ``KVConflict`` → the §2.6 replay, never as a stale commit.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from .iort import AtomicStatsMixin
from .testing import witness_lock

# Lease states.  PENDING: placeholder installed by ``begin_grant``, value
# not yet known.  LIVE: serving reads.  A killed lease is simply removed.
_PENDING, _LIVE = 0, 1


@dataclass(slots=True)
class LeaseStats(AtomicStatsMixin):
    """Cluster-wide lease counters (all client tables report here)."""

    lease_grants: int = 0
    lease_hits: int = 0
    lease_revocations: int = 0       # live/pending leases actually killed
    lease_expirations: int = 0       # lookups that found a dead-by-TTL lease
    lease_commit_skips: int = 0      # read-only commits served sans KV
    plan_invalidations: int = 0      # shared plan-cache entries dropped
    block_invalidations: int = 0     # shared block-cache entries dropped
    _stats_lock: threading.Lock = field(default_factory=threading.Lock,
                                        repr=False, compare=False)


class _Lease:
    __slots__ = ("state", "version", "value", "expires_at")

    def __init__(self, state: int, version: int = 0, value: Any = None,
                 expires_at: float = 0.0):
        self.state = state
        self.version = version
        self.value = value
        self.expires_at = expires_at


class LeaseTable:
    """Per-client lease cache; thread-safe (async op bodies run on pool
    workers sharing their client's table).  LRU-bounded."""

    MAX_LEASES = 4096

    def __init__(self, hub: "LeaseHub"):
        self._hub = hub
        self._lock = witness_lock(threading.Lock(), "lease.table")
        self._entries: "OrderedDict[Tuple[str, Any], _Lease]" = OrderedDict()
        hub.register(self)

    # -- read path ----------------------------------------------------------
    def lookup(self, sk: Tuple[str, Any]) -> Optional[Tuple[int, Any]]:
        """(version, value) when a live, unexpired lease covers ``sk``."""
        now = self._hub.clock()
        with self._lock:
            ent = self._entries.get(sk)
            if ent is None or ent.state is not _LIVE:
                return None
            if ent.expires_at <= now:
                del self._entries[sk]
                self._hub.stats.add(lease_expirations=1)
                return None
            self._entries.move_to_end(sk)
        self._hub.stats.add(lease_hits=1)
        return ent.version, ent.value

    # -- grant protocol -----------------------------------------------------
    def begin_grant(self, sk: Tuple[str, Any]) -> _Lease:
        """Install a pending placeholder BEFORE the KV read it will cache.
        Any writer's invalidation barrier between now and ``commit_grant``
        kills the placeholder, so a lease can never be born stale."""
        tok = _Lease(_PENDING)
        with self._lock:
            self._entries[sk] = tok
            self._entries.move_to_end(sk)
            while len(self._entries) > self.MAX_LEASES:
                self._entries.popitem(last=False)
        return tok

    def commit_grant(self, sk: Tuple[str, Any], tok: _Lease,
                     version: int, value: Any) -> bool:
        """Activate the placeholder with the value just read; returns False
        if a revocation (or a competing grant) killed it in the meantime."""
        with self._lock:
            if self._entries.get(sk) is not tok:
                return False
            tok.state = _LIVE
            tok.version = version
            tok.value = value
            tok.expires_at = self._hub.clock() + self._hub.ttl
        self._hub.stats.add(lease_grants=1)
        return True

    # -- revocation / validation --------------------------------------------
    def revoke(self, keys) -> int:
        """Kill leases (live or pending) for ``keys``; returns kills."""
        killed = 0
        with self._lock:
            for sk in keys:
                if self._entries.pop(sk, None) is not None:
                    killed += 1
        if killed:
            self._hub.stats.add(lease_revocations=killed)
        return killed

    def revalidate(self, used: Dict[Tuple[str, Any], int]) -> bool:
        """Atomically check that every ``sk → version`` in ``used`` is still
        covered by a live, unexpired lease at that exact version.  Runs
        under the table lock — the same lock revocation takes — so this is
        linearizable against the writers' invalidation barrier."""
        now = self._hub.clock()
        with self._lock:
            for sk, ver in used.items():
                ent = self._entries.get(sk)
                if ent is None or ent.state is not _LIVE \
                        or ent.version != ver or ent.expires_at <= now:
                    return False
        self._hub.stats.add(lease_commit_skips=1)
        return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class LeaseHub:
    """Cluster-side lease authority: fans writer-side invalidations out to
    every registered client table, and piggybacks shared plan-cache
    eviction on the (per-shard, fanned-in) WAL subscribe stream."""

    def __init__(self, kv, ttl: float, plan_cache=None, block_cache=None):
        self.ttl = float(ttl)
        self.clock = time.monotonic      # swappable in tests (expiry)
        self.stats = LeaseStats()
        self._plan_cache = plan_cache
        self._block_cache = block_cache
        self._tables: list[LeaseTable] = []
        self._tables_lock = witness_lock(threading.Lock(), "lease.tables")
        # Pre-apply barrier on every shard: correctness (see module doc).
        kv.add_invalidation_listener(self._invalidate)
        # WAL stream: cache hygiene.  Region mutations evict the shared
        # plan cache's entries for that inode (they could only fail their
        # version validation anyway; eviction keeps the LRU useful), and
        # the shared data-block cache's blocks WITH them — plan and blocks
        # always die together, the blockcache invalidation rule.
        if plan_cache is not None or block_cache is not None:
            kv.subscribe(self._on_wal)

    def register(self, table: LeaseTable) -> None:
        with self._tables_lock:
            self._tables.append(table)

    # Called by WarpKV._apply_staged under the commit's stripe locks,
    # before the first store of the committing transaction.
    def _invalidate(self, keys: list) -> None:
        with self._tables_lock:
            tables = list(self._tables)
        for t in tables:
            t.revoke(keys)

    def _on_wal(self, space: str, key: Any, value: Any,
                version: int) -> None:
        if space == "regions":
            if self._plan_cache is not None:
                dropped = self._plan_cache.drop_inode(key[0])
                if dropped:
                    self.stats.add(plan_invalidations=dropped)
            if self._block_cache is not None:
                dropped = self._block_cache.drop_inode(key[0])
                if dropped:
                    self.stats.add(block_invalidations=dropped)
