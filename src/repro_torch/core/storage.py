"""Storage servers (paper §2.2, §2.7, §2.8).

A storage server deals *exclusively* with slices and is oblivious to files,
offsets, or concurrent writers.  Its complete API is two calls:

    create_slice(data, locality_hint) -> SlicePointer
    retrieve_slice(ptr)               -> bytes

The server keeps a directory of sequentially-written backing files.  Multiple
backing files (a) avoid writer contention, (b) can spread across filesystems,
and (c) let locality hints group writes for the same metadata region into the
same backing file so that sequential file writes land sequentially on disk
(§2.7) — which is what makes compaction collapse them into single pointers.

GC (§2.8 tier 3): the server rewrites a backing file, seeking past garbage
extents, which yields a sparse file occupying space proportional to live
bytes.  Offsets are preserved, so outstanding slice pointers stay valid.
Files with the *most* garbage are collected first — they cost the least I/O
and reclaim the most space.

Readahead: each server can keep a bounded pool of speculative read buffers
(``_ReadaheadPool``).  A per-backing-file detector watches retrieval rounds;
once a file shows a sequential streak the server reads ahead of the stream
(window sized by the runtime's EWMA cost model via ``readahead_window``)
and later rounds are served from memory.  Safe because backing-file byte
ranges are immutable once written: appends only ever extend the file, GC
preserves live bytes at their offsets, and speculation is clamped to
``_BackingFile.stable_size()`` so a buffer can never capture a reservation
whose write is still in flight.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .errors import StorageError
from .iort import AtomicStatsMixin
from .placement import stable_hash
from .slicing import SlicePointer
from .testing import witness_lock


@dataclass(slots=True)
class StorageStats(AtomicStatsMixin):
    """I/O accounting — the primary hardware-independent metric (Table 2).

    ``slices_created`` counts store *rounds* accepted (one ``create_slice``
    or ``create_slices`` call each); ``slices_written`` counts the logical
    slices those rounds carried, so ``slices_written - slices_created`` is
    the number of round trips the write-path scheduler saved this server.

    The read side mirrors it since the scatter-gather RPC: ``read_rounds``
    counts retrieval *rounds* accepted (one ``retrieve_slice`` or
    ``retrieve_slices`` call each); ``slices_read`` counts the pointer
    retrievals those rounds served, so ``slices_read - read_rounds`` is
    the round trips the vectored read path saved this server.

    Rounds arrive concurrently from the runtime pool; mutation goes
    through ``add`` (atomic) — a bare ``+=`` would drop updates.
    """

    bytes_written: int = 0
    # Bytes actually read from the backing files (disk traffic): pool-hit
    # retrievals do NOT count here — their bytes were counted once, at
    # speculation time, under ``readahead_bytes`` as well.
    bytes_read: int = 0
    slices_created: int = 0
    slices_written: int = 0
    slices_read: int = 0
    read_rounds: int = 0
    # Pointer retrievals served from the readahead pool / bytes read
    # speculatively into it.
    readahead_hits: int = 0
    readahead_bytes: int = 0
    gc_bytes_reclaimed: int = 0
    gc_bytes_rewritten: int = 0
    # Seconds spent waiting to *reserve* an append offset.  The write
    # syscall itself happens outside the reservation lock, so this is
    # pure queueing delay — if concurrent appenders serialize anywhere
    # in the storage layer, it shows up here first.
    append_lock_wait_s: float = 0.0
    _stats_lock: threading.Lock = field(default_factory=threading.Lock,
                                        repr=False, compare=False)


def _merge_intervals(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge (offset, length) pairs into sorted disjoint (start, end)."""
    out: List[Tuple[int, int]] = []
    for off, ln in sorted(intervals):
        if out and off <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], off + ln))
        else:
            out.append((off, off + ln))
    return out


def _intersect_intervals(a: List[Tuple[int, int]],
                         b: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Intersection of two sorted disjoint (start, end) lists."""
    out: List[Tuple[int, int]] = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract_intervals(a: List[Tuple[int, int]],
                        sub: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """``a`` minus ``sub``; both sorted disjoint (start, end) lists."""
    out: List[Tuple[int, int]] = []
    j = 0
    for s, e in a:
        cur = s
        while j < len(sub) and sub[j][1] <= cur:
            j += 1
        k = j
        while k < len(sub) and sub[k][0] < e:
            if sub[k][0] > cur:
                out.append((cur, sub[k][0]))
            cur = max(cur, sub[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


class _BackingFile:
    """One sequentially-appended slice container.

    Appends *reserve* an offset range under the lock, then issue the
    positional write syscall OUTSIDE it, so concurrent appenders overlap
    their disk I/O instead of serializing on one file lock (§2.5's
    parallel-append guarantee has to survive the storage layer too).
    The reservation protocol:

    - ``_reserve`` bumps ``size`` and an in-flight counter under the lock
      and captures the file descriptor; the caller then ``os.pwrite``s
      into its private range — disjoint ranges never conflict.
    - GC's sparse rewrite and ``close`` must not swap the fd out from
      under an in-flight write: they set ``_blocked`` (new reservations
      park) and wait on the condition until ``_inflight`` drains.
    - Every reservation is also marked *pending handoff* until the client
      acknowledges the end of the creating transaction
      (``release_range``).  A slice is durable on disk before the commit
      publishes its pointer (§2.1), so between ``create_slice`` returning
      and the commit landing the bytes look like garbage to a metadata
      scan — and a commit can take longer than two whole GC scans.  The
      tier-3 rewrite therefore never collects a pending range, no matter
      how many scans called it garbage.
    """

    def __init__(self, path: str, stats: Optional[StorageStats] = None):
        self.path = path
        self.lock = witness_lock(threading.Lock(), "storage.backing")
        self._idle = threading.Condition(self.lock)
        self.size = 0
        self._inflight = 0
        self._blocked = False
        self._stats = stats
        self._fh = open(path, "wb+", buffering=0)
        # Sorted disjoint (start, end) ranges reserved but not yet
        # acknowledged as committed/abandoned by the creating client.
        self.pending: List[Tuple[int, int]] = []
        # Handoff ACKs race the GC's scan pipeline: a commit lands AFTER
        # the metadata walk built the live list but BEFORE the server's
        # pass runs, so the just-released range still looks like garbage
        # to that pass.  Releases therefore stay shielded until a walk
        # that STARTED after the release has confirmed them garbage:
        # (monotonic-timestamp, start, end), pruned once old enough.
        # Only recorded while GC is live on this server (``gc_active``).
        self._released: List[Tuple[float, int, int]] = []
        self.gc_active = False

    def _reserve(self, length: int) -> Tuple[int, int]:
        """Claim ``[size, size+length)``; returns (offset, fileno)."""
        t0 = time.perf_counter()
        with self.lock:
            while self._blocked:
                self._idle.wait()
            wait = time.perf_counter() - t0
            off = self.size
            self.size += length
            self._inflight += 1
            self.pending.append((off, off + length))
            fd = self._fh.fileno()
        if self._stats is not None and wait > 1e-7:
            self._stats.add(append_lock_wait_s=wait)
        return off, fd

    def release_range(self, offset: int, length: int) -> None:
        """Handoff over: the creating transaction committed (the range is
        referenced) or finally aborted (it is ordinary garbage) — either
        way scans whose walk starts after this instant see the truth.
        Idempotent."""
        with self.lock:
            self.pending = _subtract_intervals(
                self.pending, [(offset, offset + length)])
            if self.gc_active:
                self._released.append(
                    (time.monotonic(), offset, offset + length))

    def gc_shield(self, cutoff: float) -> List[Tuple[int, int]]:
        """Ranges the GC rewrite must preserve regardless of the two-scan
        verdict: everything still pending, plus every range released at or
        after ``cutoff`` (the start of the walk behind the PREVIOUS scan —
        older releases were either live in that walk or garbage it could
        trust).  Returns sorted disjoint intervals; prunes the log."""
        with self.lock:
            self._released = [r for r in self._released if r[0] >= cutoff]
            ivs = list(self.pending) + [(s, e)
                                        for _, s, e in self._released]
        ivs.sort()
        out: List[Tuple[int, int]] = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def _release(self) -> None:
        with self.lock:
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.notify_all()

    def _quiesce_locked(self) -> None:
        """With ``self.lock`` held: park new reservations and wait until
        every in-flight write has retired.  Caller must ``_unblock``."""
        self._blocked = True
        while self._inflight:
            self._idle.wait()

    def _unblock_locked(self) -> None:
        self._blocked = False
        self._idle.notify_all()

    @staticmethod
    def _pwrite_all(fd: int, data, off: int) -> None:
        view = memoryview(data)
        written = 0
        while written < len(view):
            written += os.pwrite(fd, view[written:], off + written)

    def append(self, data: bytes) -> int:
        off, fd = self._reserve(len(data))
        try:
            self._pwrite_all(fd, data, off)
        finally:
            self._release()
        return off

    def append_many(self, parts: Sequence[bytes]) -> int:
        """Append ``parts`` back-to-back in ONE reservation; returns the
        offset of the first part.  Parts are contiguous on disk, so the
        per-part pointers carved from the return value are adjacent —
        exactly what ``Extent.can_merge`` collapses at the metadata layer."""
        blob = b"".join(parts)
        off, fd = self._reserve(len(blob))
        try:
            self._pwrite_all(fd, blob, off)
        finally:
            self._release()
        return off

    def stable_size(self) -> int:
        """Prefix of the file guaranteed torn-write free: every byte below
        the first still-pending reservation is fully on disk (reservations
        are pending from ``_reserve`` until the client's handoff release,
        which happens after the write retires).  Readahead clamps here so
        a speculative buffer can never capture bytes a concurrent appender
        is still writing."""
        with self.lock:
            return self.pending[0][0] if self.pending else self.size

    def read(self, offset: int, length: int) -> bytes:
        # Positional read: no shared file-offset state between readers.
        return os.pread(self._fh.fileno(), length, offset)

    def read_into(self, buf, offset: int) -> int:
        """Positional read straight into ``buf`` (a writable memoryview) —
        the zero-copy half of the scatter-gather retrieval: parts land in
        the caller's backing buffer with no intermediate ``bytes``."""
        if hasattr(os, "preadv"):
            return os.preadv(self._fh.fileno(), [buf], offset)
        # platforms without preadv: one intermediate copy, same contract
        data = os.pread(self._fh.fileno(), len(buf), offset)
        buf[:len(data)] = data
        return len(data)

    def close(self) -> None:
        with self.lock:
            self._quiesce_locked()
            self._fh.close()


# Sequential detector: a round starting within this many bytes of the
# previous round's end (either side — coalesced batches can overlap their
# predecessor's tail) extends the streak.
_SEQ_SLOP = 256 << 10
# Rounds of in-order access before the server starts speculating.  Two
# keeps one-shot scans (and the counter assertions of single-round tests)
# readahead-free while real streams pay exactly one cold round.
_SEQ_THRESHOLD = 2
# Speculation window when no runtime cost model is wired in.
_DEFAULT_READAHEAD_WINDOW = 512 << 10
# Default per-server pool capacity (``Cluster(readahead=True)``): a few
# concurrent streams' worth of windows.
DEFAULT_READAHEAD_POOL_BYTES = 8 << 20


class _ReadaheadPool:
    """Bounded per-server pool of speculative read buffers.

    ``observe`` feeds one retrieval round into a per-backing-file
    sequential detector; once a file has streaked ``_SEQ_THRESHOLD``
    in-order rounds it returns a ``(start, stop)`` range worth reading
    ahead, and the server publishes the bytes with ``put``.  Later rounds
    covered by a pooled buffer are served from memory via ``lookup``.
    Buffers are keyed ``(backing_file, start)``, evicted LRU beyond
    ``capacity`` bytes; GC's sparse rewrite calls ``drop_file`` so punched
    garbage never lingers (pointer reads could never observe it anyway —
    punched ranges are unreferenced — but the memory is dead weight).

    Lock order: ``_lock`` is declared ``storage.readahead`` (rank 115), a
    leaf *under* ``storage.backing`` — the rewrite invalidates the pool
    while holding the backing-file lock.  Consequently nothing here may
    touch a backing file: the server performs the speculative read outside
    the pool lock and only then publishes the buffer.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lock = witness_lock(threading.Lock(), "storage.readahead")
        # global LRU of (file, start) -> immutable bytes
        self._bufs: "OrderedDict[Tuple[str, int], bytes]" = OrderedDict()
        # per-file index of pooled buffer starts (lookup scans one file's
        # handful of windows, not the whole pool)
        self._starts: Dict[str, Set[int]] = {}
        self._nbytes = 0
        # per-file detector state: name -> (last_end, streak, ra_end)
        self._streams: Dict[str, Tuple[int, int, int]] = {}

    def lookup(self, name: str, offset: int, length: int):
        """Bytes for ``[offset, offset+length)`` if pooled, else None.
        Returns the pooled ``bytes`` itself on an exact match, a zero-copy
        ``memoryview`` slice otherwise."""
        if length <= 0:
            return None
        with self._lock:
            for start in self._starts.get(name, ()):
                buf = self._bufs.get((name, start))
                if (buf is not None and start <= offset
                        and offset + length <= start + len(buf)):
                    self._bufs.move_to_end((name, start))
                    if start == offset and length == len(buf):
                        return buf
                    lo = offset - start
                    return memoryview(buf)[lo:lo + length]
        return None

    def observe(self, name: str, offset: int, end: int,
                window: int) -> Optional[Tuple[int, int]]:
        """Feed one retrieval round ``[offset, end)`` into the detector;
        returns the ``(start, stop)`` range worth speculating, or None.
        ``ra_end`` (the pool's high-water mark for this stream) advances
        in ``put`` — only bytes actually pooled count, so a clamped or
        failed speculative read simply retries on a later round."""
        with self._lock:
            last_end, streak, ra_end = self._streams.get(name, (0, 0, 0))
            if last_end - _SEQ_SLOP <= offset <= last_end + _SEQ_SLOP:
                streak += 1
            else:
                streak, ra_end = 1, 0
            new_end = max(end, last_end) if streak > 1 else end
            want = None
            if streak >= _SEQ_THRESHOLD and window > 0:
                start = max(new_end, ra_end)
                stop = new_end + window
                if stop - start >= max(1, window // 2):
                    want = (start, stop)
            self._streams[name] = (new_end, streak, ra_end)
            return want

    def put(self, name: str, start: int, data: bytes) -> None:
        n = len(data)
        if n == 0 or n > self.capacity:
            return
        with self._lock:
            key = (name, start)
            old = self._bufs.pop(key, None)
            if old is not None:
                self._nbytes -= len(old)
            self._bufs[key] = data
            self._starts.setdefault(name, set()).add(start)
            self._nbytes += n
            st = self._streams.get(name)
            if st is not None:
                self._streams[name] = (st[0], st[1], max(st[2], start + n))
            while self._nbytes > self.capacity:
                (ename, estart), ebuf = self._bufs.popitem(last=False)
                self._nbytes -= len(ebuf)
                starts = self._starts.get(ename)
                if starts is not None:
                    starts.discard(estart)
                    if not starts:
                        del self._starts[ename]

    def drop_file(self, name: str) -> None:
        """Forget every buffer and the detector state for ``name`` (GC
        sparse rewrite; called with the backing-file lock held)."""
        with self._lock:
            for start in self._starts.pop(name, ()):
                buf = self._bufs.pop((name, start), None)
                if buf is not None:
                    self._nbytes -= len(buf)
            self._streams.pop(name, None)

    def nbytes(self) -> int:
        with self._lock:
            return self._nbytes


class StorageServer:
    """One data node.  Thread-safe; writes are real file I/O."""

    def __init__(self, server_id: int, root_dir: str,
                 num_backing_files: int = 8,
                 fail_injected: bool = False,
                 service_time_s: float = 0.0,
                 readahead_pool_bytes: int = 0):
        self.server_id = server_id
        self.root_dir = root_dir
        self.num_backing_files = num_backing_files
        self.stats = StorageStats()
        self.alive = True
        self._fail_injected = fail_injected
        # Modeled per-round service time (network RTT + device latency)
        # for scaling benchmarks, mirroring the metadata plane's
        # ``kv_service_time``: in-process calls return in microseconds,
        # which hides round-trip *overlap* — the very thing parallel
        # appenders buy.  The sleep releases the GIL and is taken outside
        # every lock, so concurrent rounds genuinely overlap.
        self.service_time_s = service_time_s
        os.makedirs(root_dir, exist_ok=True)
        # Speculative-read pool (off when 0 — direct constructions and the
        # hdfs_like baseline stay readahead-free).  ``readahead_window``
        # is wired post-construction by Cluster to the runtime's EWMA
        # estimate (IoRuntime.readahead_bytes); until then a fixed window.
        self._ra_pool = (_ReadaheadPool(readahead_pool_bytes)
                         if readahead_pool_bytes > 0 else None)
        self.readahead_window: Optional[Callable[[], int]] = None
        self._files: Dict[str, _BackingFile] = {}
        self._files_lock = witness_lock(threading.Lock(), "storage.files")
        # round-robin cursor for unhinted placement; itertools.count is a
        # single atomic step, safe to bump from concurrent pool threads
        self._rr = itertools.count()
        # Two-scan GC safety rule (§2.8): a garbage byte range is only
        # collected once it has been unreferenced in two *consecutive*
        # filesystem scans (per-file garbage interval lists, intersected
        # pass over pass).
        self._gc_prev_garbage: Dict[str, List[Tuple[int, int]]] = {}
        # Start of the metadata walk behind the previous pass's live list;
        # -inf = no previous walk, shield every recorded release.
        self._gc_prev_walk_start = float("-inf")

    def _service_delay(self) -> None:
        if self.service_time_s > 0.0:
            time.sleep(self.service_time_s)

    # ------------------------------------------------------------------ API
    def create_slice(self, data: bytes,
                     locality_hint: Optional[int] = None) -> SlicePointer:
        """Write ``data`` to disk; return its self-contained pointer.

        The pointer is handed to the caller only *after* the bytes are
        durable in the backing file, which is what lets WTF serialize any
        observer of the pointer after the writing transaction (§2.1).
        """
        if not self.alive:
            raise StorageError(f"server {self.server_id} is down")
        self._service_delay()
        bf = self._pick_backing_file(locality_hint)
        off = bf.append(data)
        self.stats.add(bytes_written=len(data), slices_created=1,
                       slices_written=1)
        name = os.path.basename(bf.path)
        return SlicePointer(self.server_id, name, off, len(data))

    def create_slices(self, parts: Sequence[bytes],
                      locality_hint: Optional[int] = None
                      ) -> List[SlicePointer]:
        """Vectored store: write ``parts`` contiguously in ONE round.

        The write-path scheduler's server-side half (§2.7, §2.9): all parts
        land back-to-back in a single backing file under one lock, so one
        round trip durably stores the whole batch and the returned per-part
        pointers are disk-adjacent (the metadata layer can merge them back
        into a single covering pointer).  Pointers are returned only after
        every byte is durable — the §2.1 invariant holds batch-wide.
        """
        if not self.alive:
            raise StorageError(f"server {self.server_id} is down")
        if not parts:
            return []
        self._service_delay()
        bf = self._pick_backing_file(locality_hint)
        base = bf.append_many(parts)
        total = sum(len(p) for p in parts)
        self.stats.add(bytes_written=total, slices_created=1,
                       slices_written=len(parts))
        name = os.path.basename(bf.path)
        out: List[SlicePointer] = []
        off = base
        for p in parts:
            out.append(SlicePointer(self.server_id, name, off, len(p)))
            off += len(p)
        return out

    def release_slices(self, ptrs: Iterable[SlicePointer]) -> None:
        """Close the create→commit handoff window for ``ptrs`` (see
        ``_BackingFile``): called by the client once the transaction that
        created the slices has committed or finally aborted.  Unknown
        pointers and pointers for other servers are ignored; releasing a
        range twice is a no-op."""
        for p in ptrs:
            if p.server_id != self.server_id:
                continue
            with self._files_lock:
                bf = self._files.get(p.backing_file)
            if bf is not None:
                bf.release_range(p.offset, p.length)

    def retrieve_slice(self, ptr: SlicePointer) -> bytes:
        """Follow a pointer: open the named file, read, return (§2.2).

        Returns a bytes-like buffer: ``bytes`` off disk, possibly a
        zero-copy ``memoryview`` when served from the readahead pool.
        """
        if not self.alive:
            raise StorageError(f"server {self.server_id} is down")
        if ptr.server_id != self.server_id:
            raise StorageError(
                f"pointer for server {ptr.server_id} sent to {self.server_id}")
        self._service_delay()
        bf = self._get_backing_file(ptr.backing_file)
        data = None
        if self._ra_pool is not None:
            data = self._ra_pool.lookup(ptr.backing_file, ptr.offset,
                                        ptr.length)
        if data is not None:
            self.stats.add(slices_read=1, read_rounds=1, readahead_hits=1)
        else:
            data = bf.read(ptr.offset, ptr.length)
            if len(data) != ptr.length:
                raise StorageError(
                    f"short read: wanted {ptr.length} got {len(data)} "
                    f"from {ptr.backing_file}@{ptr.offset}")
            self.stats.add(bytes_read=len(data), slices_read=1,
                           read_rounds=1)
        if self._ra_pool is not None:
            self._maybe_readahead(bf, ptr.backing_file, ptr.offset,
                                  ptr.offset + ptr.length)
        return data

    def retrieve_slices(self, ptrs: Sequence[SlicePointer]
                        ) -> List[memoryview]:
        """Vectored retrieval: serve many pointers in ONE round (§2.2).

        The read-side mirror of ``create_slices`` — a fetch batch of
        *non-adjacent* extents on this server costs one round trip instead
        of one per run, and unlike a covering retrieval no gap bytes are
        read or shipped.  All parts land back-to-back in a single backing
        buffer and the returned ``memoryview``s alias it zero-copy; the
        caller slices them further without touching the bytes.

        The call is all-or-nothing: any dead server, wrong-server pointer
        or short read raises ``StorageError`` and the client degrades to
        per-batch/per-extent retrieval with full §2.9 replica failover.
        """
        if not self.alive:
            raise StorageError(f"server {self.server_id} is down")
        if not ptrs:
            return []
        self._service_delay()
        pool = self._ra_pool
        total = sum(p.length for p in ptrs)
        buf: Optional[memoryview] = None
        out: List[memoryview] = []
        spans: Dict[str, Tuple[int, int]] = {}
        hits = disk_bytes = 0
        off = 0
        for p in ptrs:
            if p.server_id != self.server_id:
                raise StorageError(
                    f"pointer for server {p.server_id} sent to "
                    f"{self.server_id}")
            bf = self._get_backing_file(p.backing_file)
            part = pool.lookup(p.backing_file, p.offset, p.length) \
                if pool is not None else None
            if part is not None:
                hits += 1
            else:
                if buf is None:
                    buf = memoryview(bytearray(total))
                part = buf[off:off + p.length]
                got = bf.read_into(part, p.offset) if p.length else 0
                if got != p.length:
                    raise StorageError(
                        f"short read: wanted {p.length} got {got} "
                        f"from {p.backing_file}@{p.offset}")
                disk_bytes += p.length
            out.append(part)
            off += p.length
            if pool is not None and p.length:
                lo, hi = spans.get(p.backing_file,
                                   (p.offset, p.offset + p.length))
                spans[p.backing_file] = (min(lo, p.offset),
                                         max(hi, p.offset + p.length))
        self.stats.add(bytes_read=disk_bytes, slices_read=len(ptrs),
                       read_rounds=1, readahead_hits=hits)
        # Feed the detector one span per backing file touched this round
        # (coalesced batches arrive as one round; the detector tracks the
        # stream, not individual pointers), then speculate if it streaks.
        for name, (lo, hi) in spans.items():
            self._maybe_readahead(self._get_backing_file(name), name,
                                  lo, hi)
        return out

    def _maybe_readahead(self, bf: _BackingFile, name: str,
                         lo: int, hi: int) -> None:
        """Feed ``[lo, hi)`` into the sequential detector and, on a
        streak, read ahead of the stream into the pool.  The speculative
        read happens outside every lock and is clamped to
        ``stable_size()`` so it can never observe a torn append."""
        pool = self._ra_pool
        if pool is None:
            return
        window = (self.readahead_window() if self.readahead_window
                  is not None else _DEFAULT_READAHEAD_WINDOW)
        # Never speculate less than one observed round: pool lookups
        # require full containment, so a stream of large covering reads
        # against a smaller window would pool buffers that can never
        # serve the next round — guaranteed misses.
        window = max(window, hi - lo)
        want = pool.observe(name, lo, hi, window)
        if want is None:
            return
        start, stop = want
        stop = min(stop, bf.stable_size())
        if stop <= start:
            return
        data = bf.read(start, stop - start)
        if data:
            self.stats.add(bytes_read=len(data),
                           readahead_bytes=len(data))
            pool.put(name, start, data)

    # ----------------------------------------------------------- placement
    def _pick_backing_file(self, hint: Optional[int]) -> _BackingFile:
        """Server-local hashing, salted differently from the cross-server
        ring (§2.7), so same-region writes share a backing file but regions
        that collide on a server spread across its files."""
        if hint is not None:
            idx = stable_hash(hint, salt="backing") % self.num_backing_files
        else:
            idx = next(self._rr) % self.num_backing_files
        name = f"backing_{idx:04d}.dat"
        return self._get_backing_file(name, create=True)

    def _get_backing_file(self, name: str, create: bool = False) -> _BackingFile:
        bf = self._files.get(name)
        if bf is None:
            with self._files_lock:
                bf = self._files.get(name)
                if bf is None:
                    path = os.path.join(self.root_dir, name)
                    if not create and not os.path.exists(path):
                        raise StorageError(f"no backing file {name}")
                    # wtf-lint: ignore[WTF002] -- creation is atomic under the directory lock; once per file, never on the append fast path
                    bf = _BackingFile(path, stats=self.stats)
                    if not create:
                        bf.size = os.path.getsize(path)
                    self._files[name] = bf
        return bf

    # ------------------------------------------------------------------- GC
    def disk_usage(self) -> int:
        """Apparent bytes across backing files (holes excluded by the OS;
        we track logical size here and real usage via ``real_usage``)."""
        return sum(bf.size for bf in self._files.values())

    def real_usage(self) -> int:
        """Blocks actually allocated (sparse holes don't count)."""
        total = 0
        for bf in self._files.values():
            st = os.stat(bf.path)
            total += st.st_blocks * 512
        return total

    def gc_pass(self, live: Iterable[SlicePointer],
                max_files: Optional[int] = None,
                walk_started_at: Optional[float] = None) -> dict:
        """One garbage-collection pass given the filesystem-wide live list.

        ``live`` is the in-use pointer list the metadata scan produced for
        this server (delivered via a reserved WTF directory in the real
        system — the driver in ``gc.py`` does exactly that).  Applies the
        two-consecutive-scans rule, then sparse-rewrites the files with the
        most garbage first.  ``walk_started_at`` (``time.monotonic``) is
        when the metadata walk behind ``live`` began — handoff releases
        newer than the *previous* pass's walk start stay shielded, since
        neither walk can have observed their commit.
        """
        now = time.monotonic()
        if walk_started_at is None:
            walk_started_at = now
        # Releases older than the previous walk's start were visible to
        # it: committed→live (not garbage) or abandoned→trustable garbage.
        cutoff = self._gc_prev_walk_start
        self._gc_prev_walk_start = walk_started_at
        with self._files_lock:
            for bf in self._files.values():
                bf.gc_active = True

        live_by_file: Dict[str, List[Tuple[int, int]]] = {}
        for p in live:
            if p.server_id != self.server_id:
                continue
            live_by_file.setdefault(p.backing_file, []).append(
                (p.offset, p.length))

        # Compute garbage intervals: bytes in each file not covered by live.
        garbage_now: Dict[str, List[Tuple[int, int]]] = {}
        garbage_per_file: Dict[str, int] = {}
        for name, bf in list(self._files.items()):
            merged = _merge_intervals(live_by_file.get(name, []))
            cursor, gaps = 0, []
            for off, end in merged:
                if off > cursor:
                    gaps.append((cursor, off))
                cursor = max(cursor, end)
            if bf.size > cursor:
                gaps.append((cursor, bf.size))
            garbage_now[name] = gaps
            garbage_per_file[name] = sum(e - s for s, e in gaps)

        # Two-scan rule: only byte ranges that were garbage last scan too
        # may be reclaimed — and never a range still pending its
        # create→commit handoff (a commit can outlast any number of
        # scans, so the scan-count rule alone cannot close that window).
        # The confirmed intervals — not the live list — drive the rewrite
        # below: every unconfirmed byte is preserved verbatim.
        confirmed: Dict[str, List[Tuple[int, int]]] = {}
        collectable: Dict[str, int] = {}
        for name, gaps in garbage_now.items():
            both = _intersect_intervals(
                gaps, self._gc_prev_garbage.get(name, []))
            bf = self._files.get(name)
            if bf is not None:
                both = _subtract_intervals(both, bf.gc_shield(cutoff))
            confirmed[name] = both
            collectable[name] = sum(e - s for s, e in both)
        self._gc_prev_garbage = garbage_now

        # Most-garbage-first ordering (§2.8): those files reclaim the most
        # space for the least rewrite I/O.
        by_garbage = sorted(garbage_per_file.items(),
                            key=lambda kv: kv[1], reverse=True)
        reclaimed = rewritten = files_compacted = 0
        for name, garbage in by_garbage:
            if garbage == 0 or collectable.get(name, 0) == 0:
                continue
            r, w = self._sparse_rewrite(name, confirmed.get(name, []))
            reclaimed += r
            rewritten += w
            files_compacted += 1
            if max_files is not None and files_compacted >= max_files:
                break
        self.stats.add(gc_bytes_reclaimed=reclaimed,
                       gc_bytes_rewritten=rewritten)
        return {"reclaimed": reclaimed, "rewritten": rewritten,
                "files": files_compacted}

    def _sparse_rewrite(self, name: str,
                        punch: List[Tuple[int, int]]) -> Tuple[int, int]:
        """Rewrite a backing file punching holes ONLY in ``punch`` — the
        (start, end) ranges confirmed garbage by two consecutive scans.
        Every other byte is copied verbatim: data appended after the scan
        built its live list (durable but not yet visible to the metadata
        walk) must survive the rewrite.  Offsets are preserved, so
        pointers stay valid."""
        bf = self._get_backing_file(name)
        # wtf-lint: ignore[WTF002] -- rewrite I/O under the file lock is the design: the file is quiesced (appends parked, writes drained)
        with bf.lock:
            # The rewrite swaps the file descriptor; an append writing
            # through the old fd would land in the replaced inode and be
            # lost.  Park new reservations and drain in-flight writes
            # before touching the fd (appends resume once we unblock).
            bf._quiesce_locked()
            try:
                size = bf.size
                keep: List[Tuple[int, int]] = []
                cursor = 0
                for s, e in punch:              # sorted disjoint (s, e)
                    s, e = max(0, min(s, size)), max(0, min(e, size))
                    if s > cursor:
                        keep.append((cursor, s))
                    cursor = max(cursor, e)
                if size > cursor:
                    keep.append((cursor, size))
                tmp = bf.path + ".gc"
                written = 0
                with open(tmp, "wb") as out:
                    for off, end in keep:
                        data = os.pread(bf._fh.fileno(), end - off, off)
                        out.seek(off)           # seek past garbage → hole
                        out.write(data)
                        written += end - off
                    out.truncate(max(size, 0))
                old_real = os.stat(bf.path).st_blocks * 512
                os.replace(tmp, bf.path)
                bf._fh.close()
                bf._fh = open(bf.path, "rb+", buffering=0)
                new_real = os.stat(bf.path).st_blocks * 512
                reclaimed = max(0, old_real - new_real)
                if self._ra_pool is not None:
                    # storage.backing (held) -> storage.readahead: the
                    # declared descending edge; drops any buffer holding
                    # pre-punch bytes of this file.
                    self._ra_pool.drop_file(name)
                return reclaimed, written
            finally:
                bf._unblock_locked()

    # ------------------------------------------------------------- failures
    def crash(self) -> None:
        self.alive = False

    def recover(self) -> None:
        self.alive = True

    def close(self) -> None:
        for bf in self._files.values():
            bf.close()
