"""Machine-readable declaration of the repo's global lock order.

This is the single source of truth consumed by BOTH checkers:

* the static pass (``analysis.rules`` / WTF001) maps ``with self._lock:``
  sites to levels via :data:`STATIC_LOCK_MAP` and flags acquisition edges
  that run *down* the declared order (or cycles among unranked locks), and
* the runtime witness (``core.testing.witness_lock`` /
  ``LockOrderWatchdog``) wraps the real lock objects with the same level
  names and asserts, at acquisition time, that every thread's held-lock
  stack is consistent with :data:`LOCK_LEVELS`.

Ranks ascend from outermost to innermost: a thread may only acquire a lock
whose rank is **strictly greater** than every ranked lock it already holds,
except for same-level families declared ``multi="sorted"`` (the stripe
locks), where additional locks of the same level may be taken as long as
their keys are strictly ascending — this encodes the global
``(shard, stripe)`` acquisition order that group commit and cross-shard 2PC
rely on (commit-queue < stripe < WAL, stripes sorted).

Locks that are not in the map (per-test helpers, ``_stats_lock`` leaves,
client-side caches) are simply unranked: the witness does not wrap them and
the static pass only includes them in cycle detection, not rank checks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class LockLevel:
    """One level in the global order.

    ``multi`` declares what holding *several* locks of this level means:

    * ``"none"``  — never legal to hold two distinct locks of this level;
    * ``"sorted"`` — legal iff acquired in strictly ascending ``key`` order
      (keys are supplied at ``witness_lock`` wrap time, e.g.
      ``(shard_index, stripe_id)``).
    """

    name: str
    rank: int
    multi: str = "none"            # "none" | "sorted"
    doc: str = ""


#: Declared global order, outermost (lowest rank) first.  Derived from the
#: documented protocols: group commit takes the commit queue, then the
#: sorted stripe set, then (per write) the WAL; the lease invalidation
#: barrier runs under the stripes; WAL listeners (shard fan-in, the log
#: consumer watermark, plan-cache invalidation) run under the WAL lock;
#: storage locks never nest inside metadata-plane commits the other way.
LOCK_LEVELS: Tuple[LockLevel, ...] = (
    LockLevel("repair.queue", 5,
              doc="RepairQueue ticket map (outermost: the repair daemon "
                  "may hold it only before touching any metadata/storage "
                  "lock; drain() copies tickets out and releases before "
                  "processing)"),
    LockLevel("kv.commit_queue", 10,
              doc="WarpKV group-commit queue mutex (taken alone, briefly)"),
    LockLevel("kv.stripe", 20, multi="sorted",
              doc="per-stripe RLocks; key=(shard, stripe), ascending"),
    LockLevel("lease.tables", 30,
              doc="LeaseHub registry of per-client tables"),
    LockLevel("lease.table", 40,
              doc="one client's LeaseTable (barrier revokes sequentially)"),
    LockLevel("kv.wal", 50,
              doc="per-shard WAL + listener fan-out (RLock; reentrant "
                  "commit from a listener is the documented exception)"),
    LockLevel("sub.fanin", 60,
              doc="ShardedKV.subscribe per-subscriber serialization lock"),
    LockLevel("wlog.consumer", 70,
              doc="LogConsumer commit-watermark condition"),
    LockLevel("cache.plan", 80,
              doc="PlanCache map (invalidated from WAL listeners)"),
    LockLevel("cache.block", 85,
              doc="BlockCache LRU map (invalidated from the same WAL "
                  "listeners / plan-validation failures as cache.plan; "
                  "taken after it on joint evictions)"),
    LockLevel("kv.space", 90,
              doc="WarpKV space-dict creation (leaf, under stripes)"),
    LockLevel("storage.files", 100,
              doc="StorageServer backing-file directory"),
    LockLevel("storage.backing", 110,
              doc="per-backing-file offset reservation / quiesce lock"),
    LockLevel("storage.readahead", 115,
              doc="per-server readahead buffer pool (leaf under "
                  "storage.backing: sparse rewrite invalidates the pool "
                  "while holding the backing-file lock, so the pool lock "
                  "must never wrap a backing-file read)"),
    LockLevel("kv.service", 120,
              doc="modeled metadata service-time serialization (leaf; "
                  "sleeps by design)"),
    LockLevel("iort.health", 125,
              doc="HealthTracker circuit/EWMA state (innermost leaf: "
                  "consulted from failover walks deep inside data-plane "
                  "rounds; nothing blocks or nests under it)"),
)

LEVEL_BY_NAME: Dict[str, LockLevel] = {lv.name: lv for lv in LOCK_LEVELS}
RANK: Dict[str, int] = {lv.name: lv.rank for lv in LOCK_LEVELS}


#: Exact (module basename, class name, attribute) -> level name.  ``None``
#: class matches any enclosing class (used for closure-local lock names).
STATIC_LOCK_MAP: Dict[Tuple[str, Optional[str], str], str] = {
    ("metadata", "WarpKV", "_commit_queue_lock"): "kv.commit_queue",
    ("metadata", "WarpKV", "_stripes"): "kv.stripe",
    ("metadata", "WarpKV", "_wal_lock"): "kv.wal",
    ("metadata", "WarpKV", "_space_lock"): "kv.space",
    ("metadata", "WarpKV", "_service_lock"): "kv.service",
    ("lease", "LeaseHub", "_tables_lock"): "lease.tables",
    ("lease", "LeaseTable", "_lock"): "lease.table",
    ("mdshard", None, "sub_lock"): "sub.fanin",
    ("wlog", "LogConsumer", "_cond"): "wlog.consumer",
    ("iort", "PlanCache", "_lock"): "cache.plan",
    ("iort", "HealthTracker", "_lock"): "iort.health",
    ("repair", "RepairQueue", "_lock"): "repair.queue",
    ("blockcache", "BlockCache", "_lock"): "cache.block",
    ("storage", "_ReadaheadPool", "_lock"): "storage.readahead",
    ("storage", "StorageServer", "_files_lock"): "storage.files",
    ("storage", "_BackingFile", "lock"): "storage.backing",
    ("storage", "_BackingFile", "_idle"): "storage.backing",
    # cross-object uses like ``with bf.lock:`` inside StorageServer
    ("storage", None, "lock"): "storage.backing",
}

#: Fallback mapping by attribute name alone, for code (and test fixtures)
#: that uses the canonical attribute names outside the exact modules above.
ATTR_LOCK_MAP: Dict[str, str] = {
    "_commit_queue_lock": "kv.commit_queue",
    "_stripes": "kv.stripe",
    "_wal_lock": "kv.wal",
    "_space_lock": "kv.space",
    "_service_lock": "kv.service",
    "_tables_lock": "lease.tables",
    "_files_lock": "storage.files",
    "sub_lock": "sub.fanin",
}


def level_for(module: str, cls: Optional[str], attr: str) -> Optional[str]:
    """Resolve a lock attribute to its declared level name, or ``None``."""
    hit = STATIC_LOCK_MAP.get((module, cls, attr))
    if hit is not None:
        return hit
    hit = STATIC_LOCK_MAP.get((module, None, attr))
    if hit is not None:
        return hit
    return ATTR_LOCK_MAP.get(attr)


def rank_of(level: Optional[str]) -> Optional[int]:
    if level is None:
        return None
    return RANK.get(level)


def declared_order_doc() -> str:
    """Human-readable one-liner-per-level rendering of the order."""
    lines = ["Declared lock order (outermost first):"]
    for lv in LOCK_LEVELS:
        multi = " [multi: sorted keys]" if lv.multi == "sorted" else ""
        lines.append(f"  {lv.rank:>4}  {lv.name:<16}{multi}  {lv.doc}")
    return "\n".join(lines)
