"""Three-tier garbage collection (paper §2.8).

Tier 1 — metadata compaction: replace a region's overlay list with its
compacted equivalent in one KV transaction.  No storage I/O at all; reclaims
the metadata growth caused by many appends and overlapped writes.

Tier 2 — metadata spill: when even the compacted list is too fragmented
(random writes defeat locality), serialize it into a slice and store only a
pointer.  The region list shrinks to O(1) regardless of fragmentation.

Tier 3 — storage scan: periodically walk the *entire* filesystem metadata,
build per-server in-use pointer lists, and publish them as files under the
reserved ``/.wtf-gc`` directory — servers read their own file (they link the
client library, §2.8) and sparse-rewrite their most-garbaged backing files.
The two-consecutive-scans rule (enforced inside ``StorageServer.gc_pass``)
closes the race with slices created but not yet referenced.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from .client import GC_DIR, Cluster, WtfClient
from .inode import RegionData, region_key
from .slicing import (Extent, SlicePointer, compact, decode_extents,
                      encode_extents)


class GarbageCollector:
    def __init__(self, cluster: Cluster, spill_threshold: int = 64):
        self.cluster = cluster
        self.client = cluster.client()
        self.spill_threshold = spill_threshold

    # ------------------------------------------------------------- tier 1+2
    def compact_region(self, inode_id: int, region_idx: int) -> dict:
        """Tier 1 (+ tier 2 if still fragmented), one KV transaction.

        Runs optimistically: a concurrent append bumps the region version
        and our read-dependency aborts the swap — compaction can never lose
        a write.  (We simply skip; the next pass retries.)
        """
        from .errors import KVConflict, PreconditionFailed

        kv = self.cluster.kv
        txn = kv.begin()
        rd: Optional[RegionData] = txn.get("regions",
                                           region_key(inode_id, region_idx))
        if rd is None:
            txn.abort()
            return {"skipped": True}
        entries = list(rd.entries)
        if rd.indirect is not None:
            raw = self.cluster.fetch_slice(rd.indirect.ptrs)
            entries = decode_extents(raw) + entries
        before = len(entries)
        compacted = compact(entries)
        if (rd.indirect is None and tuple(compacted) == rd.entries
                and len(compacted) <= self.spill_threshold):
            # Already minimal — the common case now that writers piggyback
            # commit-time compaction (``inode.CompactRegion``).  Rewriting
            # it anyway would bump the region version and spuriously
            # invalidate concurrent readers' plans/read sets for a no-op.
            txn.abort()
            return {"skipped": False, "noop": True, "before": before,
                    "after": len(compacted), "spilled": False}
        if len(compacted) > self.spill_threshold:
            # Tier 2: spill the compacted list into a slice; the region
            # keeps a single indirect pointer (§2.8).
            blob = encode_extents(compacted)
            ptrs = self.cluster.store_slice(
                blob, ("gc-spill", inode_id, region_idx),
                hint=inode_id)
            new = RegionData(entries=(), end=rd.end,
                             indirect=Extent(0, len(blob), ptrs))
            spilled = True
        else:
            new = RegionData(entries=tuple(compacted), end=rd.end,
                             indirect=None)
            spilled = False
        txn.put("regions", region_key(inode_id, region_idx), new)
        try:
            try:
                txn.commit()
            finally:
                # Spill slices were stored outside any client op, so the
                # create→commit GC shield is released here: published by
                # the commit, or plain garbage after the abort.
                if spilled:
                    self.cluster.release_slices(ptrs)
        except (KVConflict, PreconditionFailed):
            return {"skipped": True}
        return {"skipped": False, "before": before,
                "after": len(compacted), "spilled": spilled}

    def _walk_keys(self, space: str):
        """Deterministic space walk across the whole metadata plane.  On a
        sharded plane (``mdshard.ShardedKV``) the walk goes shard by shard
        in shard order — each shard's keys are a consistent snapshot of
        that shard, and a scan never straddles a shard boundary mid-shard —
        which also keeps the GC's iteration order stable across runs."""
        kv = self.cluster.kv
        shards = getattr(kv, "shards", None)
        if shards is None:
            yield from kv.keys(space)
            return
        for shard in shards:
            yield from shard.keys(space)

    def compact_all(self) -> dict:
        stats = {"regions": 0, "entries_before": 0, "entries_after": 0,
                 "spilled": 0, "noop": 0}
        for key in self._walk_keys("regions"):
            inode_id, region_idx = key
            r = self.compact_region(inode_id, region_idx)
            if r.get("noop"):
                stats["noop"] += 1
                continue
            if r.get("skipped"):
                continue
            stats["regions"] += 1
            stats["entries_before"] += r["before"]
            stats["entries_after"] += r["after"]
            stats["spilled"] += bool(r["spilled"])
        return stats

    # --------------------------------------------------------------- tier 3
    def scan_filesystem(self) -> Dict[int, List[SlicePointer]]:
        """Build the per-server in-use pointer lists from all metadata."""
        live: Dict[int, List[SlicePointer]] = {
            sid: [] for sid in self.cluster.servers
        }

        def note(ptrs):
            for p in ptrs:
                if p.server_id in live:
                    live[p.server_id].append(p)

        kv = self.cluster.kv
        for key in self._walk_keys("regions"):
            rd: RegionData = kv.get("regions", key)
            if rd is None:
                continue
            if rd.indirect is not None:
                note(rd.indirect.ptrs)
                for e in decode_extents(
                        self.cluster.fetch_slice(rd.indirect.ptrs)):
                    note(e.ptrs)
            for e in rd.entries:
                note(e.ptrs)
        return live

    def publish_live_lists(self, live: Dict[int, List[SlicePointer]]) -> None:
        """Store the lists as files in the reserved WTF directory (§2.8) —
        no out-of-band channel to the storage servers is needed."""
        for sid, ptrs in live.items():
            path = f"{GC_DIR}/server-{sid:03d}"
            payload = encode_extents(
                [Extent(0, p.length, (p,)) for p in ptrs])
            if self.client.exists(path):
                fd = self.client.open(path, "rw")
                self.client.truncate(fd, 0)
            else:
                fd = self.client.open(path, "w")
            self.client.write(fd, payload)
            self.client.close(fd)

    def read_live_list(self, server_id: int) -> List[SlicePointer]:
        """What a storage server does: read its own live list via the
        client library (§2.8)."""
        path = f"{GC_DIR}/server-{server_id:03d}"
        fd = self.client.open(path, "r")
        raw = self.client.read(fd)
        self.client.close(fd)
        # The GC files themselves live on the servers; exclude nothing —
        # their own extents are in the metadata scan like any other file.
        return [e.ptrs[0] for e in decode_extents(raw)]

    def storage_gc_pass(self, max_files_per_server: Optional[int] = None) -> dict:
        """One full tier-3 cycle: scan → publish → per-server collect."""
        # Stamp the walk start BEFORE reading any metadata: the servers
        # shield handoff releases newer than the previous pass's stamp,
        # because neither that walk nor this one can be trusted about
        # ranges whose commit raced the scan pipeline.
        walk_started_at = time.monotonic()
        live = self.scan_filesystem()
        self.publish_live_lists(live)
        # Re-scan after publishing so the live lists include the GC files
        # we just wrote (they are ordinary files whose slices must survive).
        live = self.scan_filesystem()
        totals = {"reclaimed": 0, "rewritten": 0, "files": 0}
        for sid, server in self.cluster.servers.items():
            if not server.alive:
                continue
            result = server.gc_pass(live.get(sid, []),
                                    max_files=max_files_per_server,
                                    walk_started_at=walk_started_at)
            for k in totals:
                totals[k] += result[k]
        return totals

    def full_cycle(self) -> dict:
        """Tier 1+2 across all regions, then a tier-3 storage pass."""
        meta = self.compact_all()
        storage = self.storage_gc_pass()
        return {"metadata": meta, "storage": storage}
