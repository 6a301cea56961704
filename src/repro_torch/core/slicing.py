"""The file-slicing algebra (paper §2.1, Figure 2).

A *slice* is an immutable, byte-addressable, arbitrarily sized sequence of
bytes living on a storage server.  A *slice pointer* is the self-contained
tuple (server id, backing file, offset, length) that locates it; sub-ranges of
slices are derived with plain arithmetic and never touch the data.

A file region's metadata is an ordered list of *extents*: each extent overlays
a slice (or zeros, for ``punch``) at a region-relative offset, and later
entries take precedence over earlier ones.  ``compact`` reduces such a list to
the minimal non-overlapping form, merging extents that are adjacent both in
the file and on disk (the payoff of locality-aware placement, §2.7).

Everything in this module is pure data manipulation: no I/O, no locking.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional, Sequence, Tuple


@dataclass(frozen=True, slots=True)
class SlicePointer:
    """Self-contained locator for an immutable slice (paper §2.1).

    Everything needed to retrieve the bytes is here; no other bookkeeping
    exists anywhere in the system.
    """

    server_id: int
    backing_file: str
    offset: int          # byte offset of the slice within the backing file
    length: int          # number of bytes

    def sub(self, start: int, length: int) -> "SlicePointer":
        """Derive a pointer to ``[start, start+length)`` of this slice.

        This is the 'simple arithmetic' the paper relies on to build new
        slice pointers that reference subsequences of existing slices.
        """
        if start < 0 or length < 0 or start + length > self.length:
            raise ValueError(
                f"sub-slice [{start},{start + length}) out of bounds "
                f"for slice of length {self.length}"
            )
        return SlicePointer(self.server_id, self.backing_file,
                            self.offset + start, length)

    def is_adjacent(self, other: "SlicePointer") -> bool:
        """True if ``other`` begins exactly where this slice ends on disk."""
        return (self.server_id == other.server_id
                and self.backing_file == other.backing_file
                and self.offset + self.length == other.offset)


@dataclass(frozen=True, slots=True)
class Extent:
    """One overlay entry in a region's metadata list.

    ``offset`` is region-relative.  ``ptrs`` holds one slice pointer per
    replica (paper §2.9: each metadata entry references multiple replica
    pointers; readers may use any).  A *zero extent* (``ptrs == ()``) reads
    back as zeros — produced by ``punch`` — and obscures extents below it.
    """

    offset: int
    length: int
    ptrs: Tuple[SlicePointer, ...] = ()

    @property
    def end(self) -> int:
        return self.offset + self.length

    @property
    def is_zero(self) -> bool:
        return not self.ptrs

    def sub(self, start: int, length: int) -> "Extent":
        """Extent covering ``[offset+start, offset+start+length)``."""
        if start < 0 or length < 0 or start + length > self.length:
            raise ValueError("sub-extent out of bounds")
        return Extent(
            offset=self.offset + start,
            length=length,
            ptrs=tuple(p.sub(start, length) for p in self.ptrs),
        )

    def at(self, new_offset: int) -> "Extent":
        """Same bytes, overlaid at a different offset (used by paste)."""
        return dataclasses.replace(self, offset=new_offset)

    def can_merge(self, nxt: "Extent") -> bool:
        """True if ``nxt`` continues this extent both in the file and on disk
        for every replica (so the pair collapses into one pointer, §2.7)."""
        if self.end != nxt.offset:
            return False
        if self.is_zero and nxt.is_zero:
            return True
        if len(self.ptrs) != len(nxt.ptrs) or self.is_zero != nxt.is_zero:
            return False
        return all(a.is_adjacent(b) for a, b in zip(self.ptrs, nxt.ptrs))

    def merge(self, nxt: "Extent") -> "Extent":
        if not self.can_merge(nxt):
            raise ValueError("extents are not mergeable")
        if self.is_zero:
            return Extent(self.offset, self.length + nxt.length, ())
        return Extent(
            self.offset,
            self.length + nxt.length,
            tuple(SlicePointer(a.server_id, a.backing_file, a.offset,
                               a.length + b.length)
                  for a, b in zip(self.ptrs, nxt.ptrs)),
        )


def overlay(entries: Sequence[Extent]) -> list[Extent]:
    """Resolve an ordered overlay list into non-overlapping extents.

    Later entries take precedence (Figure 2: slice C obscures A and B; E
    obscures D and part of C).  Returns extents sorted by offset.  Holes
    (never-written gaps) are simply absent from the output.

    Reverse sweep with a sorted coverage map: each entry contributes only
    its not-yet-covered sub-ranges, so the common append-only list resolves
    in O(n log n) (the first implementation rebuilt and re-sorted the
    resolved list per entry — O(n²) — which made bulk yank/paste quadratic;
    see EXPERIMENTS.md §Perf, WTF-side iteration 1).

    The output is *canonical*: each fragment is a maximal visible
    contiguous sub-range of one entry, sorted by offset — the unique
    decomposition of "which entry is visible at each byte".
    ``overlay_extend`` relies on this to update a resolved form
    incrementally and land on the structurally identical result.
    """
    frags: list[Extent] = []
    # sorted, disjoint covered intervals as a flat boundary list
    # [s0, e0, s1, e1, ...]
    bounds: list[int] = []
    for entry in reversed(entries):
        if entry.length == 0:
            continue
        lo, hi = entry.offset, entry.end
        # find uncovered gaps of [lo, hi) against the coverage map
        i = bisect.bisect_right(bounds, lo)
        pos = lo
        gaps: list[tuple[int, int]] = []
        if i % 2 == 1:                    # lo lands inside a covered run
            pos = bounds[i] if i < len(bounds) else hi
            i += 1
        while pos < hi:
            nxt_start = bounds[i] if i < len(bounds) else hi
            g_end = min(nxt_start, hi)
            if pos < g_end:
                gaps.append((pos, g_end))
            if i + 1 < len(bounds):
                pos = bounds[i + 1]
            else:
                pos = hi
            i += 2
        for g_lo, g_hi in gaps:
            frags.append(entry.sub(g_lo - entry.offset, g_hi - g_lo))
        # insert [lo, hi) into the coverage map (merge touching runs)
        li = bisect.bisect_left(bounds, lo)
        ri = bisect.bisect_right(bounds, hi)
        new: list[int] = []
        if li % 2 == 0:                   # lo starts outside coverage
            new.append(lo)
        if ri % 2 == 0:                   # hi ends outside coverage
            new.append(hi)
        bounds[li:ri] = new
    frags.sort(key=lambda e: e.offset)
    return frags


def _overlay_cached_impl(entries: Tuple[Extent, ...]) -> tuple:
    return tuple(overlay(entries))


try:
    from functools import lru_cache
    _overlay_cached_impl = lru_cache(maxsize=512)(_overlay_cached_impl)
except Exception:                                   # pragma: no cover
    pass


def overlay_cached(entries: Sequence[Extent]) -> list[Extent]:
    """`overlay` memoized on the (immutable) entries tuple — region lists
    are read far more often than they change (every read/yank plans against
    the same committed RegionData), so repeated resolution is pure waste.

    Entries holding non-``SlicePointer`` pointers (the write-behind
    buffer's pending placeholders, which carry the full payload bytes) are
    never memoized: caching them would pin dead payloads in this
    process-global LRU long after their transaction ended, and such lists
    are transaction-transient anyway."""
    if not isinstance(entries, tuple) or any(
            type(p) is not SlicePointer for e in entries for p in e.ptrs):
        return overlay(entries)
    return list(_overlay_cached_impl(entries))


def overlay_extend(resolved: Sequence[Extent],
                   entries: Sequence[Extent]) -> list[Extent]:
    """Incrementally overlay ``entries`` (in order, later wins) on an
    already-resolved form — the delta maintenance behind the region
    resolved index.

    ``resolved`` must be a canonical ``overlay`` result (sorted, disjoint,
    maximal fragments).  Appending k extents costs O(k log n) bisects plus
    the splice, instead of re-running ``overlay`` over the region's whole
    write history — the difference between O(1) and O(history) planning for
    a hot region absorbing a small-append stream.  Because the canonical
    decomposition is unique, the result is *structurally identical* to
    ``overlay(old_entries + entries)`` (property-tested), so read plans,
    op digests and §2.6 replays are unaffected by which path produced them.

    ``resolved`` is never mutated; a fresh list is returned.
    """
    out = list(resolved)
    for e in entries:
        if e.length == 0:
            continue
        lo, hi = e.offset, e.end
        # first fragment that can overlap [lo, hi): fragments are sorted
        # and disjoint, so offsets AND ends are both increasing
        i = bisect.bisect_right(out, lo, key=lambda f: f.end)
        j = i
        left: Optional[Extent] = None
        right: Optional[Extent] = None
        while j < len(out) and out[j].offset < hi:
            f = out[j]
            if f.offset < lo:
                left = f.sub(0, lo - f.offset)
            if f.end > hi:
                right = f.sub(hi - f.offset, f.end - hi)
            j += 1
        out[i:j] = [x for x in (left, e, right) if x is not None]
    return out


class ResolvedIndexCache:
    """Delta-maintained resolved overlays, one entry per hot region.

    Region overlay lists only ever *grow* between compactions, and WarpKV
    appends extend the stored tuple (``old + new``), so successive
    versions of a region share their prefix as identical objects.  This
    cache exploits that: keyed on ``(inode, region)``, it remembers the
    last entries tuple and its resolved form, and when asked about a
    longer tuple with an identical prefix it applies only the delta via
    ``overlay_extend`` — O(k log n) for k appended extents — instead of
    re-resolving the entire history (the quadratic planning cost a hot
    region's small-append + re-read stream used to pay).

    The prefix check compares object *identity*, so a false hit is
    impossible: any wholesale replacement (compaction, truncate, GC
    tier-1/2, a relative append's commit-time re-resolution) fails the
    check and falls back to a full ``overlay``.  Entries carrying
    non-``SlicePointer`` pointers (write-behind pending placeholders)
    bypass the cache entirely, mirroring ``overlay_cached``: they are
    transaction-private and must never be pinned here.

    Thread-safe (async op bodies plan from pool workers).  Stored resolved
    lists are never mutated — ``overlay_extend`` copies — so returned
    references are safe to read outside the lock.
    """

    __slots__ = ("maxsize", "_lock", "_entries")

    def __init__(self, maxsize: int = 512):
        self.maxsize = maxsize
        self._lock = threading.Lock()
        # key -> (entries_tuple, resolved_list)
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def resolve(self, key: tuple, entries: Tuple[Extent, ...],
                stats=None) -> list[Extent]:
        """Resolved overlay of ``entries``; ``stats`` (duck-typed
        ``ClientStats``) records ``resolved_index_hits``/``_misses``.

        Resolution itself runs OUTSIDE the cache lock — a cold large
        region must not stall every other planner (async op bodies plan
        concurrently).  Racing resolutions of the same key just do
        duplicate work; the canonical form makes either result correct.
        """
        if any(type(p) is not SlicePointer for e in entries for p in e.ptrs):
            return overlay(entries)          # pending placeholders: bypass
        base = None
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                tup, res = ent
                n = len(tup)
                if len(entries) >= n:
                    i = 0
                    while i < n and entries[i] is tup[i]:
                        i += 1
                    if i == n:
                        if len(entries) == n:
                            if stats is not None:
                                stats.add(resolved_index_hits=1)
                            return res
                        base = res
        if base is not None:
            out = overlay_extend(base, entries[n:])
        else:
            out = overlay(entries)
        with self._lock:
            self._store(key, entries, out)
        if stats is not None:
            if base is not None:
                stats.add(resolved_index_hits=1)
            else:
                stats.add(resolved_index_misses=1)
        return out

    def _store(self, key: tuple, tup: Tuple[Extent, ...],
               resolved: list) -> None:
        self._entries[key] = (tup, resolved)
        self._entries.move_to_end(key)
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


def merge_adjacent(extents: Sequence[Extent]) -> list[Extent]:
    """Collapse runs that are contiguous in the file *and* on disk into
    single pointers — the compaction payoff of locality-aware placement."""
    merged: list[Extent] = []
    for ext in extents:
        if merged and merged[-1].can_merge(ext):
            merged[-1] = merged[-1].merge(ext)
        else:
            merged.append(ext)
    return merged


def compact(entries: Sequence[Extent]) -> list[Extent]:
    """Minimal metadata list equivalent to ``entries`` (Figure 2 'Compacted').

    Overlay resolution + adjacent-slice merging.  The result reconstructs the
    identical bytes while never referencing data obscured by later writes.
    """
    return merge_adjacent(overlay(entries))


def visible_length(entries: Sequence[Extent]) -> int:
    """Highest written offset in the overlay list (region-relative end)."""
    return max((e.end for e in entries), default=0)


def slice_range(
    entries: Sequence[Extent], start: int, length: int
) -> list[Extent]:
    """Extents covering ``[start, start+length)`` of the resolved overlay.

    Gaps (holes) are returned as zero extents so that the output tiles the
    requested range exactly.  This is the read/yank planner: each returned
    extent is either a zero run or a sub-sliced pointer to fetch.
    """
    return slice_resolved(overlay_cached(entries), start, length)


def slice_resolved(
    resolved: Sequence[Extent], start: int, length: int
) -> list[Extent]:
    """``slice_range`` against an already-resolved overlay.

    Vectored ops plan many ranges against the same region; resolving (and
    cache-hashing) the entry list once per op instead of once per range,
    and bisecting into the sorted disjoint overlay instead of scanning it,
    is what keeps a 4096-range ``yankv`` O(n log n) instead of O(n²)."""
    if length <= 0:
        return []
    end = start + length
    out: list[Extent] = []
    cursor = start
    # first extent that can overlap [start, end): the one at or before start
    i = bisect.bisect_right(resolved, start, key=lambda e: e.offset) - 1
    if i < 0:
        i = 0
    for ext in resolved[i:]:
        if ext.offset >= end:
            break
        if ext.end <= start:
            continue
        lo = max(ext.offset, start)
        hi = min(ext.end, end)
        if lo > cursor:                      # hole before this extent
            out.append(Extent(cursor, lo - cursor, ()))
        out.append(ext.sub(lo - ext.offset, hi - lo))
        cursor = hi
    if cursor < end:                         # trailing hole
        out.append(Extent(cursor, end - cursor, ()))
    return out


def shift(entries: Iterable[Extent], delta: int) -> list[Extent]:
    """Translate extents by ``delta`` bytes (region <-> file coordinates)."""
    return [dataclasses.replace(e, offset=e.offset + delta) for e in entries]


def split_by_regions(
    offset: int, length: int, region_size: int
) -> Iterator[Tuple[int, int, int, int]]:
    """Split a file-absolute byte range into per-region pieces.

    Yields (region_index, region_relative_offset, piece_offset_in_range,
    piece_length) — used by writes/pastes that cross region boundaries
    (Figure 3: write C is atomically applied to both region lists).
    """
    pos = offset
    end = offset + length
    while pos < end:
        region = pos // region_size
        rel = pos - region * region_size
        take = min(end - pos, region_size - rel)
        yield region, rel, pos - offset, take
        pos += take


# ---------------------------------------------------------------------------
# Serialization — extents must round-trip through slices themselves for the
# tier-2 GC (metadata spilled into a slice, §2.8) and for directory files.
# ---------------------------------------------------------------------------

def encode_extents(extents: Sequence[Extent]) -> bytes:
    from repro_torch.util import jsonio

    return jsonio.dumps([
        {
            "o": e.offset,
            "l": e.length,
            "p": [[p.server_id, p.backing_file, p.offset, p.length]
                  for p in e.ptrs],
        }
        for e in extents
    ])


def decode_extents(data: bytes) -> list[Extent]:
    from repro_torch.util import jsonio

    return [
        Extent(
            offset=d["o"],
            length=d["l"],
            ptrs=tuple(SlicePointer(*p) for p in d["p"]),
        )
        for d in jsonio.loads(data)
    ]
