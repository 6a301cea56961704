"""File-slicing surface and the client data plane — the middle layer of the
split client (see ``client.py`` for how the layers assemble).

Public surface (Table 1 plus the vectored extensions):

  * scalar: ``yank``/``paste``/``punch``/``append``/``append_slices``/
    ``concat``/``copy``;
  * vectored: ``yankv(fd, ranges)`` plans many byte ranges in one
    transaction, ``pastev(fd, batches)`` overlays many extent batches
    back-to-back at the fd offset as a single atomic op.

This module also owns the shared data-plane engine used by the POSIX layer:
range planning (``_plan_range``), batched fetching through the
``iosched.SliceScheduler`` (``_fetch``/``_fetch_many``), slice creation
(``_data_slice`` scalar, ``_data_slices`` batched through the
``wsched.WriteScheduler``), and the write/paste engines
(``_write_at``/``_writev_at``/``_paste_at``).
Writers create slices on storage servers *before* their metadata commits, so
any transaction that can observe a slice pointer can safely dereference it —
the cornerstone invariant of the design (§2.1).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .client_runtime import _Ctx, _Op
from .errors import (InvalidOffset, KVConflict, NotFound,
                     PreconditionFailed, TransactionAborted, WtfError)
from .inode import (AppendExtents, BumpInode, ClearRegion, CompactRegion,
                    Inode, RegionData, ResetInode, region_key)
from .placement import region_placement_key, stable_hash
from .slicing import (Extent, decode_extents, merge_adjacent, overlay_cached,
                      shift, slice_resolved, split_by_regions)
from .wbuf import (extent_is_pending, extent_is_resolved,
                   pending_extent_bytes, resolve_extent)
from .wsched import StoreRequest


class SliceOps:
    """Mixin: slicing API + data-plane engine for ``WtfClient``."""

    # ============================================= public API: file slicing
    def yank(self, fd: int, size: int, want_data: bool = False):
        """Copy ``size`` bytes from fd as slice pointers (Table 1)."""
        return self._run("yank", fd, size, want_data)

    def paste(self, fd: int, extents: Sequence[Extent]) -> int:
        """Write slices to fd at its offset — metadata only, zero data I/O."""
        return self._run("paste", fd, tuple(extents))

    def punch(self, fd: int, amount: int) -> int:
        """Zero ``amount`` bytes at the offset, freeing underlying storage."""
        return self._run("punch", fd, amount)

    def append(self, fd: int, data: bytes) -> int:
        """Append with the §2.5 relative-append fast path (commutative)."""
        return self._run("append", fd, bytes(data))

    def append_slices(self, fd: int, extents: Sequence[Extent]) -> int:
        return self._run("append_slices", fd, tuple(extents))

    def concat(self, sources: Sequence[str], dest: str) -> None:
        """Concatenate files by metadata alone (Table 1)."""
        from .client_runtime import normalize_path
        return self._run("concat",
                         tuple(normalize_path(s) for s in sources),
                         normalize_path(dest))

    def copy(self, source: str, dest: str) -> None:
        from .client_runtime import normalize_path
        return self._run("copy", normalize_path(source), normalize_path(dest))

    # ----------------------------------------------- vectored slicing API
    def yankv(self, fd: int,
              ranges: Sequence[Tuple[int, int]]) -> List[Tuple[Extent, ...]]:
        """Plan many ``(offset, length)`` ranges of fd as slice pointers in
        one transaction — positional (the fd offset does not move) and
        zero data I/O.  Returns one extent tuple per requested range."""
        return list(self._run("yankv", fd,
                              tuple((int(o), int(n)) for o, n in ranges)))

    def pastev(self, fd: int,
               batches: Sequence[Sequence[Extent]]) -> int:
        """Overlay many extent batches back-to-back at the fd offset as one
        atomic op; advances the offset past everything pasted and returns
        the total byte count.  Replaces N scalar ``paste`` calls with one
        logged op — one transaction, one replay unit, O(regions) commit."""
        return self._run("pastev", fd,
                         tuple(tuple(b) for b in batches))

    # ============================================================ op bodies
    def _op_yank(self, ctx: _Ctx, op: _Op, fd: int, size: int,
                 want_data: bool):
        f = self._get_fd(fd)
        ino = self._inode(ctx, f.inode_id)
        length = self._file_length(ctx, ino)
        size = min(size, max(0, length - f.offset))
        extents = self._plan_range(ctx, ino, f.offset, size)
        data = None
        if want_data:
            data = self._fetch(extents, inode_id=ino.inode_id)
            if type(data) is not bytes:
                data = bytes(data)     # user-facing yank payload
            self.stats.add(logical_bytes_read=size)
        f.offset += size
        extents = tuple(extents)
        return (extents, data) if want_data else extents

    def _op_yankv(self, ctx: _Ctx, op: _Op, fd: int,
                  ranges: Tuple[Tuple[int, int], ...]):
        _, plans = self._clamped_plans(ctx, fd, ranges)
        self.stats.add(vectored_ops=1)
        return tuple(tuple(p) for p in plans)

    def _clamped_plans(self, ctx: _Ctx, fd: int,
                       ranges: Sequence[Tuple[int, int]]):
        """Shared readv/yankv prologue: EOF-clamp every range exactly like
        scalar ``pread``, then plan them all with one overlay resolution
        per region.  Rejects negative offsets/sizes (EINVAL-style) instead
        of producing undefined plans.  Returns (fd record, plans)."""
        f = self._get_fd(fd)          # EBADF before EINVAL, like POSIX
        for off, size in ranges:
            if off < 0 or size < 0:
                raise InvalidOffset(
                    f"negative range ({off}, {size}) in vectored read plan")
        ino = self._inode(ctx, f.inode_id)
        length = self._file_length(ctx, ino)
        clamped = [(off, min(size, max(0, length - off)))
                   for off, size in ranges]
        return f, self._plan_many_cached(ctx, ino, clamped)

    def _op_paste(self, ctx: _Ctx, op: _Op, fd: int,
                  extents: Tuple[Extent, ...]) -> int:
        f = self._get_wfd(fd)
        n = self._paste_at(ctx, f.inode_id, f.offset,
                           self._realize_app_extents(extents))
        f.offset += n
        self.stats.add(logical_bytes_written=n)
        return n

    def _op_pastev(self, ctx: _Ctx, op: _Op, fd: int,
                   batches: Tuple[Tuple[Extent, ...], ...]) -> int:
        f = self._get_wfd(fd)
        flat = [e for batch in batches for e in batch]
        n = self._paste_at(ctx, f.inode_id, f.offset,
                           self._realize_app_extents(flat))
        f.offset += n
        self.stats.add(logical_bytes_written=n, vectored_ops=1)
        return n

    def _op_punch(self, ctx: _Ctx, op: _Op, fd: int, amount: int) -> int:
        f = self._get_wfd(fd)
        ino = self._inode(ctx, f.inode_id)
        max_r = -1
        for r, rel, _, ln in split_by_regions(f.offset, amount,
                                              ino.region_size):
            self._commute_region_append(ctx, ino.inode_id, r,
                                        AppendExtents([Extent(rel, ln, ())]))
            max_r = max(max_r, r)
        self._bump(ctx, ino.inode_id, op, max_region=max_r)
        f.offset += amount
        return amount

    def _op_append(self, ctx: _Ctx, op: _Op, fd: int, data: bytes) -> int:
        f = self._get_wfd(fd)
        return self._append_fd(ctx, op, f, data)

    def _append_fd(self, ctx: _Ctx, op: _Op, f, data: bytes) -> int:
        """Append ``data`` at the file's current EOF — shared by the
        ``append`` op and by ``write``/``writev`` on O_APPEND fds."""
        ino = self._inode(ctx, f.inode_id)
        last = max(ino.max_region, 0)
        # Unvalidated fit check: the commit-time bound precondition is the
        # real guard, so concurrent appends carry no read dependency (§2.5).
        rd = ctx.txn.peek("regions", region_key(ino.inode_id, last),
                          RegionData())
        if rd.end + len(data) <= ino.region_size:
            # Fast path (§2.5): commutative bounded append — resolved against
            # the region's end at commit time, so concurrent appends all
            # commit without conflicting.  The peek above already counted
            # the region's overlay entries, so pass that down rather than
            # paying a second KV read for the compaction-threshold check.
            full = self._data_slice(ctx, op, ino, last, data, key="a")
            self._commute_region_append(
                ctx, ino.inode_id, last,
                AppendExtents([Extent(0, len(data), full.ptrs)],
                              relative=True, bound=ino.region_size),
                base_hint=len(rd.entries))
            self._bump(ctx, ino.inode_id, op, max_region=last)
        else:
            # Fallback: read end-of-file and write at that offset (§2.5);
            # a replay reuses the already-written slice ("paste the
            # previously written slice at the new end of file").
            eof = self._file_length(ctx, ino)
            self._write_at(ctx, op, ino.inode_id, eof, data, key="a")
        self.stats.add(logical_bytes_written=len(data))
        return len(data)

    def _op_append_slices(self, ctx: _Ctx, op: _Op, fd: int,
                          extents: Tuple[Extent, ...]) -> int:
        f = self._get_wfd(fd)
        ino = self._inode(ctx, f.inode_id)
        eof = self._file_length(ctx, ino)
        n = self._paste_at(ctx, f.inode_id, eof,
                           self._realize_app_extents(extents))
        self.stats.add(logical_bytes_written=n)
        return n

    def _op_concat(self, ctx: _Ctx, op: _Op, sources: Tuple[str, ...],
                   dest: str) -> None:
        cursor = 0
        if ctx.txn.get("paths", dest) is None:
            self._create_file(ctx, op, dest, None)
        dest_ino = self._inode_at(ctx, dest)
        for src in sources:
            ino = self._inode_at(ctx, src)
            length = self._file_length(ctx, ino)
            extents = self._plan_range(ctx, ino, 0, length)
            cursor += self._paste_at(ctx, dest_ino.inode_id, cursor, extents)
        self.stats.add(logical_bytes_written=cursor)

    def _op_copy(self, ctx: _Ctx, op: _Op, source: str, dest: str) -> None:
        return self._op_concat(ctx, op, (source,), dest)

    # ------------------------------------------------------------ internals
    def _inode(self, ctx: _Ctx, inode_id: int) -> Inode:
        # get_view: BumpInode commutes queued earlier in this transaction
        # (e.g. a paste growing max_region) must be visible to later ops.
        ino = ctx.txn.get_view("inodes", inode_id)
        if ino is None:
            raise NotFound(f"inode {inode_id}")
        return ino

    def _inode_at(self, ctx: _Ctx, path: str) -> Inode:
        ino_id = ctx.txn.get("paths", path)
        if ino_id is None:
            raise NotFound(path)
        return self._inode(ctx, ino_id)

    def _commute_region_append(self, ctx: _Ctx, inode_id: int, region: int,
                               append_op: AppendExtents,
                               base_hint: Optional[int] = None) -> None:
        """Queue a region-list append, piggybacking a commit-time compaction
        (``CompactRegion``) when the overlay list has outgrown the cluster
        threshold.

        The length check is an unvalidated snapshot read plus a count of
        this transaction's queued extents — it records NO read dependency
        and, unlike ``peek``, never materializes the queued view (a
        multi-op transaction hammering one region would otherwise re-apply
        its whole commute chain per call).  Triggering (or not) can never
        make appends conflict (§2.5), and the op re-checks the threshold
        at commit time, so a stale estimate only costs a no-op.  One
        compaction per (transaction, region) is enough: it runs at its
        queue position and the threshold keeps post-compaction growth
        bounded until the next committing writer.

        ``base_hint`` lets a caller that just peeked the region (the
        append fast path) supply its entry count, saving the snapshot
        read; a hint that includes this transaction's queued extents only
        *over*estimates, which at worst queues a compaction early — the
        same harmless no-op as any stale estimate."""
        txn = ctx.txn
        rk = region_key(inode_id, region)
        txn.commute("regions", rk, append_op)
        thr = self.cluster.region_compact_threshold
        if thr is None:
            return
        queued = 0
        for entry in txn._commutes_by_key.get(("regions", rk), ()):
            cop = entry[2]
            if isinstance(cop, CompactRegion):
                return                       # one per (txn, region)
            if isinstance(cop, AppendExtents):
                queued += len(cop.extents)
            elif isinstance(cop, ClearRegion):
                queued = 0
        sk = ("regions", rk)
        if sk in txn._writes:                # rare (GC-style raw put)
            rd = txn.peek("regions", rk)
            base = len(rd.entries) if rd is not None else 0
            queued = 0                       # peek already applied the queue
        elif base_hint is not None:
            base = base_hint
        else:
            _, val = self.kv._read_versioned("regions", rk)
            base = len(val.entries) if val is not None else 0
        if base + queued >= thr:
            txn.commute("regions", rk, CompactRegion(thr))

    def _bump(self, ctx: _Ctx, inode_id: int, op: _Op,
              max_region: Optional[int] = None) -> None:
        now = op.artifacts.setdefault("mtime", self.time_fn())
        ctx.txn.commute("inodes", inode_id,
                        BumpInode(max_region=max_region, mtime=now))

    def _file_length(self, ctx: _Ctx, ino: Inode) -> int:
        if ino.max_region < 0:
            return 0
        rd = ctx.txn.get_view("regions",
                              region_key(ino.inode_id, ino.max_region),
                              RegionData())
        return ino.max_region * ino.region_size + rd.end

    def _region_entries(self, ctx: _Ctx, ino: Inode,
                        region_idx: int) -> list[Extent]:
        rd = ctx.txn.get_view("regions",
                              region_key(ino.inode_id, region_idx))
        if rd is None:
            return ()
        if rd.indirect is None:
            # return the stored tuple itself: `overlay_cached` memoizes on
            # it, so repeated reads of an unchanged region plan in O(1)
            return rd.entries
        # Tier-2 GC: the bulk of the list lives in a slice (§2.8).
        base = decode_extents(self._fetch([rd.indirect]))
        return tuple(base) + tuple(rd.entries)

    def _resolve_region(self, ctx: _Ctx, ino: Inode,
                        region_idx: int) -> Sequence[Extent]:
        """Resolved overlay of one region, via the client's delta-maintained
        resolved index (``slicing.ResolvedIndexCache``) when available.

        Region lists only grow between compactions and WarpKV appends
        extend the stored tuple in place, so a hot region's re-read costs
        O(appended delta) instead of O(full write history).  Any wholesale
        replacement (compaction, truncate, GC) fails the cache's identity
        check and re-resolves; entries carrying write-behind pending
        placeholders bypass the index entirely.

        Tier-2 spilled regions (§2.8 ``indirect``) rebuild their entry
        tuple from freshly-decoded extents on every read, so the identity
        check could never hit — they stay on ``overlay_cached``, whose
        equality-based memoization serves them in one tuple hash."""
        rd = ctx.txn.get_view("regions",
                              region_key(ino.inode_id, region_idx))
        if rd is None:
            return ()
        cache = self._rcache
        if rd.indirect is not None or cache is None \
                or not isinstance(rd.entries, tuple):
            return overlay_cached(self._region_entries(ctx, ino, region_idx))
        return cache.resolve((ino.inode_id, region_idx), rd.entries,
                             stats=self.stats)

    def _plan_range(self, ctx: _Ctx, ino: Inode, offset: int,
                    length: int) -> list[Extent]:
        """File-absolute extents (incl. zero runs) tiling [offset, +length)."""
        out: list[Extent] = []
        for r, rel, _, ln in split_by_regions(offset, length,
                                              ino.region_size):
            part = slice_resolved(self._resolve_region(ctx, ino, r), rel, ln)
            out.extend(shift(part, r * ino.region_size))
        return merge_adjacent(out)

    def _plan_many(self, ctx: _Ctx, ino: Inode,
                   ranges: Sequence[Tuple[int, int]]) -> List[List[Extent]]:
        """Plan many ranges, resolving each touched region's overlay once.

        The per-op ``resolved`` map keeps vectored planning O(ranges log n)
        (one resolution per region per op); the per-client resolved index
        behind ``_resolve_region`` keeps that one resolution O(delta) for
        hot regions across ops."""
        resolved: dict = {}
        plans: List[List[Extent]] = []
        for offset, length in ranges:
            out: list[Extent] = []
            for r, rel, _, ln in split_by_regions(offset, length,
                                                  ino.region_size):
                res = resolved.get(r)
                if res is None:
                    res = self._resolve_region(ctx, ino, r)
                    resolved[r] = res
                part = slice_resolved(res, rel, ln)
                out.extend(shift(part, r * ino.region_size))
            plans.append(merge_adjacent(out))
        return plans

    def _plan_many_cached(self, ctx: _Ctx, ino: Inode,
                          ranges: Sequence[Tuple[int, int]]
                          ) -> List[List[Extent]]:
        """``_plan_many`` behind the version-validated read-plan cache.

        A hot re-read of the same ``(inode, ranges)`` skips overlay
        resolution entirely when every touched region still carries the
        KV version the plan was built against; validation records the
        same read dependencies a fresh plan would, so a hit is exactly as
        serializable as a miss.  Any commit whose commutes touched a
        region bumped its version — that IS the invalidation rule.

        Bypassed (like ``overlay_cached``) whenever this transaction could
        see state no other transaction can: queued commutes or buffered
        writes, or pending write-behind extents in the plan.
        """
        cache = getattr(self, "_plan_cache", None)
        txn = ctx.txn
        if (cache is None or txn._commutes or txn._writes
                or self._wb.pending):
            return self._plan_many(ctx, ino, ranges)
        key = (ino.inode_id, tuple(ranges))
        entry = cache.get(key)
        if entry is not None:
            versions, plans = entry
            if all(txn.get_version("regions", rk) == ver
                   for rk, ver in versions):
                self.stats.add(plan_cache_hits=1)
                return [list(p) for p in plans]
            # An invalidating commit moved a touched region's version:
            # the inode's plans AND its cached data blocks die together
            # (the shared invalidation rule — see ``blockcache``).  The
            # stale blocks were unreachable anyway (new plans carry new
            # pointers); eviction keeps both LRUs useful.
            cache.drop_inode(ino.inode_id)
            bc = getattr(self, "_block_cache", None)
            if bc is not None:
                bc.drop_inode(ino.inode_id)
        regions = sorted({
            r for off, ln in ranges
            for r, _, _, _ in split_by_regions(off, ln, ino.region_size)})
        plans = self._plan_many(ctx, ino, ranges)
        if any(extent_is_pending(e) for p in plans for e in p):
            return plans               # never cache pending extents
        versions = tuple(
            (region_key(ino.inode_id, r),
             txn.get_version("regions", region_key(ino.inode_id, r)))
            for r in regions)
        if all(ver is not None for _, ver in versions):
            cache.put(key, (versions, tuple(tuple(p) for p in plans)))
            self.stats.add(plan_cache_misses=1)
        return plans

    def _read_range(self, ctx: _Ctx, ino: Inode, offset: int,
                    length: int) -> bytes:
        if length <= 0:
            return b""
        data = self._fetch(self._plan_range(ctx, ino, offset, length),
                           inode_id=ino.inode_id)
        # The scalar boundary: internal fetch paths hand around zero-copy
        # buffers; scalar read/pread (and ``_dir_entries``) promise bytes.
        return data if type(data) is bytes else bytes(data)

    def _fetch(self, extents: Sequence[Extent], inode_id=None) -> bytes:
        """Dereference pointers through the batched scheduler (replica-
        failover aware, §2.9); pending write-behind extents are served from
        the buffer's memory (read-your-buffered-writes)."""
        return self._fetch_many([extents], inode_id=inode_id)[0]

    def _fetch_many(self, plans: Sequence[Sequence[Extent]],
                    inode_id=None) -> List[bytes]:
        """Dereference many plans in one scheduler pass: cross-plan
        coalescing plus per-server fan-out.

        Pending-write overlay: while the write-behind buffer holds deferred
        stores, plan extents whose pointers are still pending never reach
        the scheduler — their bytes come straight from the buffered
        payloads, so reads inside the transaction observe its own writes.

        Every call that actually dispatches storage rounds counts one
        ``blocked_waits``: a synchronous fetch blocks the application by
        definition (the async surface's waits count only when the future
        was not yet done — the overlap the runtime exists to create)."""
        if any(not e.is_zero and not extent_is_pending(e)
               for p in plans for e in p):
            self.stats.add(blocked_waits=1)
        bc = self._block_cache
        if not self._wb.pending:
            return self.cluster.scheduler.fetch_many(
                plans, stats=self.stats, block_cache=bc, inode_id=inode_id)
        parts: List[List[bytes]] = [[b""] * len(p) for p in plans]
        sched_plans: List[List[Extent]] = []
        slots: List[tuple] = []
        for pi, plan in enumerate(plans):
            for ci, e in enumerate(plan):
                if extent_is_pending(e):
                    parts[pi][ci] = pending_extent_bytes(e)
                else:
                    sched_plans.append([e])
                    slots.append((pi, ci))
        if sched_plans:
            # Pending extents above never reach the scheduler (served from
            # the write-behind buffer), so they structurally bypass the
            # block cache; committed extents in the same plan still use it.
            datas = self.cluster.scheduler.fetch_many(sched_plans,
                                                      stats=self.stats,
                                                      block_cache=bc,
                                                      inode_id=inode_id)
            for (pi, ci), data in zip(slots, datas):
                parts[pi][ci] = data
        return [b"".join(p) for p in parts]

    def _realize_app_extents(self, extents: Sequence[Extent]) -> list:
        """Normalize application-supplied extents (paste/append_slices):
        pending pointers that already flushed become their real replicated
        pointers; unresolved ones are legal only while this client's buffer
        is still open (they will be rewritten at the commit flush)."""
        out = []
        for e in extents:
            if extent_is_pending(e):
                if extent_is_resolved(e):
                    e = resolve_extent(e)
                elif not self._wb.owns(e):
                    # a dead pointer (aborted scope, or another client's
                    # buffer) must fail HERE, not poison this commit's flush
                    raise WtfError(
                        "extent references an unflushed write-behind "
                        "buffer from another commit scope")
            out.append(e)
        return out

    def _data_slice(self, ctx: _Ctx, op: _Op, ino: Inode, region: int,
                    data: bytes, key: str,
                    defer: Optional[bool] = None) -> Extent:
        """Create one (replicated) slice for ``data``, placed for ``region``.

        Created on first execution only; replays reuse the recorded pointers
        verbatim — the §2.6 op log holds slice pointers, never data.  A write
        that crosses a region boundary stays a *single* slice; each region's
        list gets a sub-ranged pointer (Figure 3, write C).

        ``defer`` overrides the live write-behind check: async op bodies run
        on pool threads and must not consult (or touch) the application
        thread's buffer, so they pin the decision at submission time.
        """
        cached = op.artifacts.get(key)
        if cached is not None:
            return cached
        if defer is None:
            defer = self._write_behind_active()
        if defer:
            # Deferred: record the payload; the store happens at the commit
            # flush, batched with every other op in this commit scope.
            pk = region_placement_key(ino.inode_id, region)
            ext = self._wb.add(pk, stable_hash(pk), data, op_tag=id(op))
            op.artifacts[key] = ext
            return ext
        hint = stable_hash(region_placement_key(ino.inode_id, region))
        ptrs = self.cluster.store_slice(
            data, region_placement_key(ino.inode_id, region), hint)
        self.stats.add(data_bytes_written=len(data) * len(ptrs),
                       store_batches=len(ptrs))  # one round per replica store
        if len(ptrs) < self.cluster.replication:
            self.stats.add(degraded_stores=1)
        ext = Extent(0, len(data), ptrs)
        op.artifacts[key] = ext
        return ext

    def _data_slices(self, ctx: _Ctx, op: _Op, ino: Inode,
                     pieces: Sequence[Tuple[int, bytes]],
                     key: str,
                     defer: Optional[bool] = None) -> Tuple[Extent, ...]:
        """Create (replicated) slices for many ``(region, data)`` pieces as
        ONE scheduled store batch (``wsched``): all stores are planned up
        front, grouped per (server, backing file), small adjacent pieces
        coalesce into covering stores, and distinct servers are written
        concurrently.  Created on first execution only; replays reuse the
        recorded extents verbatim, exactly like ``_data_slice`` (§2.6).
        ``defer`` pins the write-behind decision (see ``_data_slice``).
        """
        cached = op.artifacts.get(key)
        if cached is not None:
            return cached
        if defer is None:
            defer = self._write_behind_active()
        if defer:
            exts = []
            for region, data in pieces:
                pk = region_placement_key(ino.inode_id, region)
                exts.append(self._wb.add(pk, stable_hash(pk), data,
                                         op_tag=id(op)))
            exts = tuple(exts)
            op.artifacts[key] = exts
            return exts
        requests = []
        for i, (region, data) in enumerate(pieces):
            pk = region_placement_key(ino.inode_id, region)
            requests.append(StoreRequest(i, data, pk, stable_hash(pk)))
        ptrs = self.cluster.store_slices(requests, stats=self.stats)
        exts = tuple(Extent(0, len(data), ptrs[i])
                     for i, (_, data) in enumerate(pieces))
        op.artifacts[key] = exts
        return exts

    def _writev_at(self, ctx: _Ctx, op: _Op, inode_id: int, offset: int,
                   chunks: Sequence[bytes], key: str,
                   defer: Optional[bool] = None) -> int:
        """Vectored write engine: plan one store per (chunk, region) piece,
        dispatch the whole plan through the write scheduler, then queue each
        region's extents as one AppendExtents.  Pieces of one region share a
        placement group, so a many-chunk gather-write still lands as a
        single covering slice per region (one store round), while a write
        spanning regions fans out across the ring in parallel."""
        ino = self._inode(ctx, inode_id)
        pieces: list[Tuple[int, int, bytes]] = []   # (region, rel, data)
        cursor = offset
        for chunk in chunks:
            for r, rel, po, ln in split_by_regions(cursor, len(chunk),
                                                   ino.region_size):
                pieces.append((r, rel, chunk[po:po + ln]))
            cursor += len(chunk)
        exts = self._data_slices(ctx, op, ino,
                                 [(r, d) for r, _, d in pieces], key,
                                 defer=defer)
        max_r = ino.max_region
        per_region: dict[int, list[Extent]] = {}
        for (r, rel, _), ext in zip(pieces, exts):
            per_region.setdefault(r, []).append(ext.at(rel))
            max_r = max(max_r, r)
        for r, items in per_region.items():
            self._commute_region_append(ctx, inode_id, r,
                                        AppendExtents(items))
        self._bump(ctx, inode_id, op, max_region=max_r)
        total = cursor - offset
        self.stats.add(logical_bytes_written=total)
        return total

    def _write_at(self, ctx: _Ctx, op: _Op, inode_id: int, offset: int,
                  data: bytes, key: str) -> int:
        ino = self._inode(ctx, inode_id)
        first_region = offset // ino.region_size
        full = self._data_slice(ctx, op, ino, first_region, data, key)
        max_r = ino.max_region
        for r, rel, po, ln in split_by_regions(offset, len(data),
                                               ino.region_size):
            self._commute_region_append(
                ctx, inode_id, r, AppendExtents([full.sub(po, ln).at(rel)]))
            max_r = max(max_r, r)
        self._bump(ctx, inode_id, op, max_region=max_r)
        self.stats.add(logical_bytes_written=len(data))
        return len(data)

    def _paste_at(self, ctx: _Ctx, inode_id: int, offset: int,
                  extents: Sequence[Extent]) -> int:
        """Overlay existing slices at ``offset`` — pure metadata, no I/O.

        Pieces are grouped per region and queued as ONE AppendExtents per
        region: queueing them one-by-one made the commute-coalescing path
        rebuild its extent tuple per piece — O(n²) for a bulk ``pastev``.
        Cursor order is preserved inside each group, so overlay precedence
        is identical."""
        ino = self._inode(ctx, inode_id)
        cursor = offset
        max_r = ino.max_region
        per_region: dict[int, list[Extent]] = {}
        for e in extents:
            consumed = 0
            while consumed < e.length:
                r = cursor // ino.region_size
                rel = cursor - r * ino.region_size
                take = min(e.length - consumed, ino.region_size - rel)
                per_region.setdefault(r, []).append(
                    e.sub(consumed, take).at(rel))
                max_r = max(max_r, r)
                cursor += take
                consumed += take
        for r, pieces in per_region.items():
            self._commute_region_append(ctx, inode_id, r,
                                        AppendExtents(pieces))
        op = _Op("paste_internal", (), {})
        self._bump(ctx, inode_id, op, max_region=max_r)
        return cursor - offset

    # ------------------------------------------------------ async op bodies
    # Worker-thread engines behind the futures surface (``posix_ops``
    # submits them to the cluster's ``IoRuntime``).  They never touch the
    # fd table, the op log, or the write-behind buffer — everything
    # fd-dependent is resolved on the application thread at submission —
    # so they are safe to run concurrently with the application's own ops.

    def _async_readv_body(self, inode_id: int,
                          ranges: Tuple[Tuple[int, int], ...]) -> List[bytes]:
        """Plan + fetch for an async vectored read, on a pool worker.

        Planning happens HERE, at execution time, not at submission: a
        commit that lands while the future is still queued bumps the
        touched region versions, so the plan (cached or fresh) is built
        against — and validated against — the post-commit state.  A stale
        cached plan can never be served; the version check re-plans it.
        The planning transaction commits (validating its read versions)
        before any data round is issued, so the bytes returned are a
        serializable snapshot.
        """
        last: Optional[Exception] = None
        for attempt in range(self.MAX_RETRIES):
            if attempt:
                self.stats.add(txn_retries=1)
            ctx = _Ctx(self._begin_txn(), first=(attempt == 0))
            try:
                ino = self._inode(ctx, inode_id)
                length = self._file_length(ctx, ino)
                clamped = [(off, min(size, max(0, length - off)))
                           for off, size in ranges]
                plans = self._plan_many_cached(ctx, ino, clamped)
                ctx.txn.commit()
            except (KVConflict, PreconditionFailed) as e:
                last = e
                continue
            # Slices are immutable, so fetching after the metadata commit
            # is safe; rounds issued from a worker run inline (iort).
            out = self.cluster.scheduler.fetch_many(
                plans, stats=self.stats, block_cache=self._block_cache,
                inode_id=inode_id)
            self.stats.add(logical_bytes_read=sum(len(b) for b in out),
                           vectored_ops=1)
            return out
        self.stats.add(txn_aborts=1)
        raise TransactionAborted(
            f"async readv failed after {self.MAX_RETRIES} attempts: {last}")

    def _async_pwritev_body(self, inode_id: int,
                            chunks: Tuple[bytes, ...], offset: int) -> int:
        """Store + metadata commit for an async gather-write, on a worker.

        The §2.1 order holds: slices are durable (through the write
        scheduler) before the metadata commit; KV-level aborts retry with
        the op's recorded artifacts, so data is never stored twice.
        ``defer=False`` pins the write-behind decision made at submission —
        a worker must never touch the application thread's buffer.
        """
        op = _Op("pwritev_async", (), {})
        last: Optional[Exception] = None
        try:
            for attempt in range(self.MAX_RETRIES):
                if attempt:
                    self.stats.add(txn_retries=1)
                ctx = _Ctx(self._begin_txn(), first=(attempt == 0))
                try:
                    n = self._writev_at(ctx, op, inode_id, offset, chunks,
                                        key="wv", defer=False)
                    ctx.txn.commit()
                    self.stats.add(vectored_ops=1)
                    return n
                except (KVConflict, PreconditionFailed) as e:
                    last = e
                    continue
        finally:
            # commit or give-up: the GC handoff window for the slices this
            # worker stored is closed (retries reuse them, so only here).
            self._release_handoffs((op,))
        self.stats.add(txn_aborts=1)
        raise TransactionAborted(
            f"async pwritev failed after {self.MAX_RETRIES} attempts: {last}")

    def _truncate_inode(self, ctx: _Ctx, ino: Inode, length: int) -> None:
        """Truncate to zero via commit-time commutes (``ClearRegion`` /
        ``ResetInode``) so queue order decides what survives: writes queued
        earlier in the same transaction are wiped, later ones kept.  The
        caller must pass the *view* inode (``_inode``) so regions grown by
        this transaction's own queued writes are cleared too."""
        if length != 0:
            raise WtfError("only truncate-to-zero is supported")
        for r in range(ino.max_region + 1):
            ctx.txn.commute("regions", region_key(ino.inode_id, r),
                            ClearRegion())
        ctx.txn.commute("inodes", ino.inode_id, ResetInode(self.time_fn()))
