"""Client-side data-block cache: hot re-reads cost zero storage rounds.

A bounded LRU of retrieved extents keyed by the extent's canonical slice
pointer ``(server_id, backing_file, offset, length)`` — the first replica,
which is replica-independent because every replica of an extent stores the
same bytes.  The read scheduler (``iosched.SliceScheduler.fetch_many``)
consults it before building fetch batches and inserts fetched extents
after, so a fully cached read issues *no* storage retrieval round at all —
the data-plane mirror of how metadata leases (PR 6) made hot re-reads cost
zero KV rounds.

Correctness has two independent layers:

* **Pointer immutability** — backing-file byte ranges are append-only and
  never reused: overwrites allocate new extents at new offsets (hence new
  cache keys) and GC preserves live bytes at their offsets, so an entry
  looked up by a *currently valid* pointer is always byte-correct.
* **Version validation** — staleness is therefore a *plan*-level property,
  and the cache shares the exact invalidation rule of the PR 4
  ``PlanCache``: a plan-cache hit is revalidated against the touched
  regions' KV versions, and a failed validation (an invalidating commit
  moved the region version) drops the inode's plans *and* its blocks
  together; on lease-enabled clusters the lease hub's WAL subscription
  does the same eviction on every "regions" write (and hence on lease
  revocation).  A stale block can never satisfy a read: its pointer is no
  longer reachable from any validated plan.

Write-behind pending extents bypass the cache structurally: the overlay
serves them from the client buffer before plans ever reach the scheduler.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Set, Tuple

from .slicing import SlicePointer
from .testing import witness_lock

#: Default ``Cluster(block_cache_bytes=…)``: a client-scale working set,
#: small enough that a cache per client (the no-lease default) stays cheap.
DEFAULT_BLOCK_CACHE_BYTES = 8 << 20

#: Cache key: canonical (server_id, backing_file, offset, length).
BlockKey = Tuple[int, str, int, int]


def block_key(ptr: SlicePointer) -> BlockKey:
    """Canonical replica-independent key for an extent's first replica."""
    return (ptr.server_id, ptr.backing_file, ptr.offset, ptr.length)


class BlockCache:
    """Byte-bounded LRU of retrieved data blocks (see module docstring).

    Thread-safe; like ``PlanCache`` one instance is shared cluster-wide on
    lease-enabled clusters and per-client otherwise.  ``_lock`` is the
    declared ``cache.block`` level, ranked just after ``cache.plan`` so
    the joint plan+block evictions (WAL listener, validation failure)
    nest in the declared order.
    """

    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        # A single giant extent must not evict the whole working set.
        self.max_entry = max(1, capacity_bytes // 4)
        self._lock = witness_lock(threading.Lock(), "cache.block")
        self._entries: "OrderedDict[BlockKey, bytes]" = OrderedDict()
        self._nbytes = 0
        # inode id -> live keys, so invalidation is O(the inode's blocks).
        self._by_inode: Dict[int, Set[BlockKey]] = {}
        self._inode_of: Dict[BlockKey, int] = {}

    def get(self, key: BlockKey) -> Optional[bytes]:
        with self._lock:
            data = self._entries.get(key)
            if data is not None:
                self._entries.move_to_end(key)
            return data

    def put(self, key: BlockKey, data, inode_id: int) -> None:
        """Insert ``data`` (any buffer; stored as a compact ``bytes`` copy
        so a small block never pins a large covering blob)."""
        n = len(data)
        if n == 0 or n > self.max_entry:
            return
        blob = data if type(data) is bytes else bytes(data)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._nbytes -= len(old)
                self._drop_index_locked(key)
            self._entries[key] = blob
            self._nbytes += n
            self._by_inode.setdefault(inode_id, set()).add(key)
            self._inode_of[key] = inode_id
            while self._nbytes > self.capacity:
                oldest, buf = self._entries.popitem(last=False)
                self._nbytes -= len(buf)
                self._drop_index_locked(oldest)

    def _drop_index_locked(self, key: BlockKey) -> None:
        ino = self._inode_of.pop(key, None)
        if ino is None:
            return
        keys = self._by_inode.get(ino)
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_inode[ino]

    def drop_inode(self, inode_id: int) -> int:
        """Evict every block for ``inode_id``; returns entries dropped.
        Called from the same sites that drop the inode's plans."""
        with self._lock:
            keys = self._by_inode.pop(inode_id, None)
            if not keys:
                return 0
            for key in keys:
                buf = self._entries.pop(key, None)
                if buf is not None:
                    self._nbytes -= len(buf)
                self._inode_of.pop(key, None)
            return len(keys)

    def nbytes(self) -> int:
        with self._lock:
            return self._nbytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_inode.clear()
            self._inode_of.clear()
            self._nbytes = 0
