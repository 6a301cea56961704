"""Locality-aware slice placement via consistent hashing (paper §2.7).

Writes for the same metadata region always map to the same storage server,
and — via a *differently salted* hash at the server level — to the same
backing file on that server.  A sequential writer therefore lays its bytes
down sequentially on one disk, which compaction later collapses into single
slice pointers spanning the contiguous range.

Hashes are content-stable (blake2b) rather than Python's randomized
``hash()`` so placement is deterministic across processes and restarts —
a requirement for pointers that outlive any single process.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Any, Hashable, List, Sequence


def stable_hash(*parts: Any, salt: str = "") -> int:
    h = hashlib.blake2b(digest_size=8, person=salt.encode()[:16] or b"wtf")
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x00")
    return int.from_bytes(h.digest(), "big")


class HashRing:
    """Consistent-hashing ring [Karger et al. 97] with virtual nodes."""

    VNODES = 64

    def __init__(self, server_ids: Sequence[int] = ()):
        self._points: List[int] = []
        self._owners: List[int] = []
        self._servers: set[int] = set()
        for sid in server_ids:
            self.add_server(sid)

    def add_server(self, server_id: int) -> None:
        if server_id in self._servers:
            return
        self._servers.add(server_id)
        for v in range(self.VNODES):
            point = stable_hash(server_id, v, salt="ring")
            idx = bisect.bisect(self._points, point)
            self._points.insert(idx, point)
            self._owners.insert(idx, server_id)

    def remove_server(self, server_id: int) -> None:
        if server_id not in self._servers:
            return
        self._servers.discard(server_id)
        keep = [(p, o) for p, o in zip(self._points, self._owners)
                if o != server_id]
        self._points = [p for p, _ in keep]
        self._owners = [o for _, o in keep]

    @property
    def servers(self) -> frozenset:
        return frozenset(self._servers)

    def owner(self, key: Hashable) -> int:
        """The server responsible for ``key`` (first vnode clockwise)."""
        if not self._points:
            raise RuntimeError("hash ring has no servers")
        point = stable_hash(key, salt="key")
        idx = bisect.bisect(self._points, point) % len(self._points)
        return self._owners[idx]

    def owners(self, key: Hashable, n: int) -> List[int]:
        """``n`` distinct servers for ``key`` — the replica set (§2.9)."""
        if not self._points:
            raise RuntimeError("hash ring has no servers")
        n = min(n, len(self._servers))
        point = stable_hash(key, salt="key")
        idx = bisect.bisect(self._points, point)
        out: List[int] = []
        seen: set[int] = set()
        for i in range(len(self._points)):
            owner = self._owners[(idx + i) % len(self._points)]
            if owner not in seen:
                seen.add(owner)
                out.append(owner)
                if len(out) == n:
                    break
        return out


def region_placement_key(inode_id: int, region_idx: int) -> tuple:
    """The identity of a metadata region — what the writer hands the ring so
    that all writes to one region land on one server (§2.7)."""
    return ("region", inode_id, region_idx)
