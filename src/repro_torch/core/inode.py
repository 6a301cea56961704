"""Inodes, regions, and their commit-time commutative operations.

File metadata layout in WarpKV (paper §2.1, §2.3, §2.4):

  space "paths"   : normalized pathname -> inode id      (one-lookup open)
  space "inodes"  : inode id -> Inode                    (standard inode info)
  space "regions" : (inode id, region index) -> RegionData

A file is partitioned into fixed-size regions, each holding its own ordered
extent list plus ``end`` — the highest offset written in the region, which is
what makes the paper's *relative append* possible: an append is a commit-time
commutative operation whose precondition is "still fits in this region", so
concurrent appenders never conflict (§2.5).

All values are immutable dataclasses: WarpKV hands out references, so nothing
may be mutated in place.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from .metadata import CommutingOp
from .slicing import Extent, compact, visible_length

DEFAULT_REGION_SIZE = 64 * 1024 * 1024   # 64 MB, matching the evaluation §4

# Overlay-list length at which writers piggyback a commit-time compaction
# (``CompactRegion``) onto their transaction.  Large enough that explicit
# GC tier-1 passes (and the tests driving them) still see uncompacted
# history below it; small enough to bound hot-region planning cost.
REGION_COMPACT_THRESHOLD = 64


@dataclass(frozen=True, slots=True)
class Inode:
    inode_id: int
    kind: str                   # "file" | "dir"
    links: int = 1
    mtime: int = 0
    mode: int = 0o644
    owner: str = "root"
    group: str = "root"
    region_size: int = DEFAULT_REGION_SIZE
    # Reference to the highest-offset region written (§2.4) — lets clients
    # find end-of-file with a single extra region lookup.  -1 == empty file.
    max_region: int = -1

    def replace(self, **kw) -> "Inode":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True, slots=True)
class RegionData:
    """One region's metadata list.

    ``indirect`` is the tier-2 GC state (§2.8): when a compacted list is
    still too fragmented, it is serialized into a slice and the region keeps
    only a pointer to it; ``entries`` then holds extents appended since.
    """

    entries: Tuple[Extent, ...] = ()
    end: int = 0                      # region-relative high-water mark
    indirect: Optional[Extent] = None


class AppendExtents(CommutingOp):
    """Atomic append of extents to a region list — the HyperDex list-append
    WTF's correctness rests on (§2.1).

    ``relative=True`` implements the paper's relative append: extent offsets
    are ignored and resolved against the region's current ``end`` *at commit
    time*, with the precondition that the result still fits below ``bound``.
    Appends therefore commute: they never carry a read dependency and never
    abort each other.
    """

    __slots__ = ("extents", "relative", "bound", "total")

    def __init__(self, extents, relative: bool = False,
                 bound: Optional[int] = None):
        self.extents = tuple(extents)
        self.relative = relative
        self.bound = bound
        self.total = sum(e.length for e in self.extents)

    def precondition(self, value) -> bool:
        if self.bound is None:
            return True
        end = value.end if value is not None else 0
        return end + self.total <= self.bound

    def apply(self, value):
        rd = value if value is not None else RegionData()
        if self.relative:
            cursor = rd.end
            resolved = []
            for e in self.extents:
                resolved.append(e.at(cursor))
                cursor += e.length
            resolved = tuple(resolved)
        else:
            resolved = self.extents
        new_end = max([rd.end] + [e.end for e in resolved])
        return (RegionData(rd.entries + resolved, new_end, rd.indirect),
                resolved)

    def coalesce(self, nxt: "AppendExtents") -> Optional["AppendExtents"]:
        """Append-of-append composes exactly: [A]+[B] == [A,B] (relative
        cursors chain; a combined bound check is equivalent because a
        failing prefix fails the whole transaction either way).  Bulk
        paste/concat queue thousands of appends on a handful of regions —
        coalescing keeps transaction views and commits O(keys)."""
        if (self.relative != nxt.relative or self.bound != nxt.bound):
            return None
        return AppendExtents(self.extents + nxt.extents,
                             relative=self.relative, bound=self.bound)


class CompactRegion(CommutingOp):
    """Commit-time, threshold-triggered incremental compaction (§2.8 tier 1
    moved onto the commit path).

    Writers piggyback this op when a region's overlay list outgrows the
    cluster threshold, so hot regions never accumulate unbounded history
    between explicit GC passes.  The §2.5 append contract is preserved on
    both sides:

      * no read dependency, no precondition — a compaction can never make
        two transactions conflict;
      * ``version_preserving``: the compacted list reconstructs byte-
        identical content (``compact`` only drops obscured extents and
        merges disk-adjacent ones), so WarpKV keeps the region's version
        unchanged when applying it.  Readers holding a read dependency or
        a cached plan against the pre-compaction value stay valid — their
        plans reference only visible byte ranges, all of which the
        compacted pointers still cover — and are NOT spuriously aborted.

    Slices referenced only by dropped (obscured) extents become garbage
    for the tier-3 collector; the two-consecutive-scans rule in
    ``StorageServer.gc_pass`` already covers the handoff.

    Below the threshold (or on a wiped region) the op is a no-op and —
    per WarpKV's no-op-merge rule — bumps nothing at all.
    """

    version_preserving = True
    __slots__ = ("threshold",)

    def __init__(self, threshold: int):
        self.threshold = threshold

    def apply(self, value):
        rd = value
        if rd is None or len(rd.entries) < self.threshold:
            return value, 0
        compacted = tuple(compact(rd.entries))
        if compacted == rd.entries:
            return value, 0
        return (RegionData(compacted, rd.end, rd.indirect),
                len(rd.entries) - len(compacted))


class ReplaceExtentPtrs(CommutingOp):
    """Repair-plane replica-set swap (§2.9 healing, ``core.repair``).

    ``mapping`` takes an entry's exact pointer tuple to its repaired
    replacement — surviving replicas first (in their original order, so the
    canonical first pointer stays stable whenever replica 0 survived, and
    the PR 9 block-cache key with it), freshly re-replicated pointers
    appended.  Committed as a commuting op so repair NEVER conflicts with
    concurrent appenders: no read dependency, no precondition, and entries
    the mapping misses (compacted or truncated away between the repair scan
    and this commit) are simply left alone for the next scan.

    NOT ``version_preserving``: replica sets are observable to read
    planners, so the version bump is exactly what invalidates
    version-validated cached plans that still point at the dead replica.
    """

    __slots__ = ("mapping",)

    def __init__(self, mapping):
        self.mapping = dict(mapping)

    def apply(self, value):
        rd = value
        if rd is None:
            return value, 0
        swapped = 0
        entries = []
        for e in rd.entries:
            new_ptrs = self.mapping.get(e.ptrs)
            if new_ptrs is None:
                entries.append(e)
            else:
                entries.append(Extent(e.offset, e.length, new_ptrs))
                swapped += 1
        indirect = rd.indirect
        if indirect is not None:
            new_ptrs = self.mapping.get(indirect.ptrs)
            if new_ptrs is not None:
                indirect = Extent(indirect.offset, indirect.length, new_ptrs)
                swapped += 1
        if swapped == 0:
            # Returning the operand untouched engages WarpKV's no-op-merge
            # rule: nothing is written, nothing is bumped.
            return value, 0
        return RegionData(tuple(entries), rd.end, indirect), swapped


class ClearRegion(CommutingOp):
    """Commit-time region wipe (truncate-to-zero).

    Queued as a commutative op — NOT a raw ``delete`` — so it composes with
    appends queued in the same transaction in queue order: extents queued
    *before* the truncate are wiped with the region, extents queued *after*
    survive.  A raw delete was applied before all commutes at commit,
    resurrecting earlier in-txn writes.  The ``None`` result value is the
    same tombstone a delete leaves.
    """

    __slots__ = ()

    def apply(self, value):
        return None, None


class ResetInode(CommutingOp):
    """Truncate-to-zero's inode half: reset ``max_region`` in queue order
    (earlier in-txn bumps are cancelled, later ones re-raise it), merging
    ``mtime`` and leaving the link count untouched."""

    __slots__ = ("mtime",)

    def __init__(self, mtime: int):
        self.mtime = mtime

    def precondition(self, value) -> bool:
        return value is not None        # file must still exist

    def apply(self, value: Inode):
        kw = {"max_region": -1}
        if self.mtime > value.mtime:
            kw["mtime"] = self.mtime
        return value.replace(**kw), None


class BumpInode(CommutingOp):
    """Monotone inode update: ``max_region``/``mtime`` merge by max.

    Because WarpKV skips the version bump when a commutative op leaves the
    value unchanged, appends that stay within the current last region do not
    invalidate concurrent readers of the inode — this is what keeps parallel
    appends conflict-free end to end.

    An *mtime-only* advance additionally keeps the inode's version
    (``preserves_version``): timestamps carry no serializability promise
    in POSIX, so ticking ``mtime`` must not abort concurrent appenders
    holding an inode read dependency, nor invalidate cached read plans.
    Any structural change (``max_region`` growth, link count) still bumps
    the version — that is what serializes appends against truncate and
    namespace ops.
    """

    __slots__ = ("max_region", "mtime", "link_delta")

    def __init__(self, max_region: Optional[int] = None,
                 mtime: Optional[int] = None,
                 link_delta: int = 0):
        self.max_region = max_region
        self.mtime = mtime
        self.link_delta = link_delta

    def precondition(self, value) -> bool:
        return value is not None        # file must still exist

    def apply(self, value: Inode):
        ino = value
        kw = {}
        if self.max_region is not None and self.max_region > ino.max_region:
            kw["max_region"] = self.max_region
        if self.mtime is not None and self.mtime > ino.mtime:
            kw["mtime"] = self.mtime
        if self.link_delta:
            kw["links"] = ino.links + self.link_delta
        return (ino.replace(**kw) if kw else ino), None

    def preserves_version(self, old, new) -> bool:
        return (isinstance(old, Inode) and isinstance(new, Inode)
                and new.replace(mtime=old.mtime) == old)

    def coalesce(self, nxt: "BumpInode") -> "BumpInode":
        def mx(a, b):
            if a is None:
                return b
            if b is None:
                return a
            return max(a, b)
        return BumpInode(max_region=mx(self.max_region, nxt.max_region),
                         mtime=mx(self.mtime, nxt.mtime),
                         link_delta=self.link_delta + nxt.link_delta)


def region_key(inode_id: int, region_idx: int) -> tuple:
    return (inode_id, region_idx)
