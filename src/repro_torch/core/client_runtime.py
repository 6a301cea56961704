"""Client transaction/replay runtime (paper §2.6) — the bottom layer of the
split client.

The client library is assembled from three layers (see ``client.py``):

  * ``client_runtime`` (this module): fd table, per-client stats, op logging,
    the auto-commit retry loop, and ``WtfTransaction`` — the fully general
    multi-file transaction with transparent KV-abort replay;
  * ``slice_ops``: the data plane (slice planning, batched fetch, write/paste
    engines) and the file-slicing API surface;
  * ``posix_ops``: the POSIX-style surface (open/read/write/...) and the
    directory machinery.

Every application call is logged as an ``_Op`` with its arguments and its
application-visible outcome digest.  On a HyperDex-level abort (KVConflict /
PreconditionFailed) the filesystem is unchanged, so the whole op log is
replayed with the original arguments; if any replayed call's outcome differs
from what the application already observed, the transaction aborts to the
application — otherwise the replay commits invisibly.
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .errors import (BadFileDescriptor, KVConflict, NotOpenForWriting,
                     PreconditionFailed, TransactionAborted, WtfError)
from .iort import AtomicStatsMixin
from .metadata import Transaction
from .slicing import Extent, SlicePointer

SEEK_SET, SEEK_CUR, SEEK_END = 0, 1, 2


@dataclass
class _Fd:
    fd: int
    inode_id: int
    path: str
    offset: int = 0
    writable: bool = True
    # O_APPEND semantics: every write() lands at the file's CURRENT end,
    # not at the offset this fd cached when it was opened.  Routed through
    # the §2.5 relative append so concurrent appenders commute.
    append: bool = False

    def snap(self) -> tuple:
        return (self.fd, self.inode_id, self.path, self.offset,
                self.writable, self.append)

    @staticmethod
    def restore(t: tuple) -> "_Fd":
        return _Fd(*t)


@dataclass(slots=True)
class ClientStats(AtomicStatsMixin):
    """Logical I/O accounting as seen by this client (drives Table 2).

    ``fetch_batches`` / ``slices_coalesced`` measure the batched slice-fetch
    scheduler (``iosched``): each batch is one storage-server round, and each
    coalesced slice is a pointer dereference the scheduler folded into an
    adjacent one instead of issuing separately.  ``store_batches`` /
    ``slices_store_coalesced`` are the write-side mirror (``wsched``): store
    rounds issued vs. slice creations folded into a shared round.
    ``degraded_stores`` counts stores that achieved fewer than
    ``replication`` replicas (available but under-replicated, §2.9).
    ``writeback_flushes`` counts write-behind buffer flushes (one per
    commit scope that had deferred stores), and
    ``slices_cross_op_coalesced`` counts slice creations that coalesced
    into a covering store together with slices planned by a *different*
    logged op — the cross-op batching only the write-behind buffer enables.

    The async I/O runtime adds: ``async_ops`` (ops submitted through the
    futures surface), ``blocked_waits`` (data-plane waits the application
    actually blocked on — every synchronous fetch counts one; an async
    ``result()`` counts one only when the future was not yet done), and
    ``plan_cache_hits``/``plan_cache_misses`` (read plans served from /
    installed into the version-validated plan cache).

    The metadata-plane fast path adds ``resolved_index_hits`` /
    ``resolved_index_misses``: region overlay resolutions served by the
    delta-maintained resolved index (an O(delta) extension of a cached
    resolved form) vs. full ``overlay`` re-resolutions installed into it.

    Counters may be bumped from runtime pool threads concurrently with the
    application thread; all mutation goes through ``add`` (atomic, from
    ``iort.AtomicStatsMixin``) — a bare ``+=`` would drop updates.
    """

    data_bytes_written: int = 0      # bytes physically sent to storage servers
    data_bytes_read: int = 0         # bytes physically fetched (incl. gaps)
    logical_bytes_written: int = 0   # bytes the app asked to write/paste
    logical_bytes_read: int = 0      # bytes the app asked to read/yank
    txn_retries: int = 0
    txn_aborts: int = 0
    fetch_batches: int = 0           # storage-server rounds issued (reads)
    slices_coalesced: int = 0        # pointer fetches saved by coalescing
    store_batches: int = 0           # storage-server rounds issued (writes)
    slices_store_coalesced: int = 0  # slice creations saved by coalescing
    degraded_stores: int = 0         # stores with fewer replicas than asked
    vectored_ops: int = 0            # readv/writev/yankv/pastev batches run
    writeback_flushes: int = 0       # write-behind buffer flushes run
    slices_cross_op_coalesced: int = 0  # creations coalesced across ops
    async_ops: int = 0               # ops submitted via the async surface
    blocked_waits: int = 0           # data-plane waits the app blocked on
    plan_cache_hits: int = 0         # read plans served from the plan cache
    plan_cache_misses: int = 0       # read plans installed into the cache
    block_cache_hits: int = 0        # extents served from the block cache
    block_cache_misses: int = 0      # extents fetched then installed
    resolved_index_hits: int = 0     # overlays served by delta extension
    resolved_index_misses: int = 0   # overlays fully re-resolved + cached
    _stats_lock: threading.Lock = field(default_factory=threading.Lock,
                                        repr=False, compare=False)


class _Ctx:
    """Execution context: one WarpKV transaction + replay bookkeeping."""

    __slots__ = ("txn", "first")

    def __init__(self, txn: Transaction, first: bool):
        self.txn = txn
        self.first = first               # first execution vs. replay


class _Op:
    __slots__ = ("name", "args", "kwargs", "digest", "artifacts")

    def __init__(self, name: str, args: tuple, kwargs: dict):
        self.name = name
        self.args = args
        self.kwargs = kwargs
        self.digest: Any = None
        self.artifacts: dict = {}        # slices created, ids allocated, ...


def _iter_slice_pointers(obj: Any):
    """Every ``SlicePointer`` reachable from an op-artifact value: bare
    pointers, replica tuples inside ``Extent``s, and arbitrary nesting in
    tuples/lists/dicts.  Unresolved write-behind placeholders simply have
    no pointers yet and yield nothing."""
    if isinstance(obj, SlicePointer):
        yield obj
    elif isinstance(obj, Extent):
        yield from _iter_slice_pointers(obj.ptrs)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _iter_slice_pointers(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _iter_slice_pointers(v)


def _digest(value: Any) -> Any:
    """Stable comparison token for an op's application-visible outcome."""
    if isinstance(value, (bytes, bytearray, memoryview)):
        return ("bytes", hashlib.blake2b(bytes(value), digest_size=16).digest())
    if isinstance(value, tuple):
        return tuple(_digest(v) for v in value)
    if isinstance(value, list):
        return ("list",) + tuple(_digest(v) for v in value)
    if isinstance(value, dict):
        return ("dict",) + tuple(sorted((k, _digest(v))
                                        for k, v in value.items()))
    return value


def normalize_path(path: str) -> str:
    if not path.startswith("/"):
        raise WtfError(f"paths must be absolute: {path!r}")
    parts = [p for p in path.split("/") if p and p != "."]
    out: list[str] = []
    for p in parts:
        if p == "..":
            if out:
                out.pop()
        else:
            out.append(p)
    return "/" + "/".join(out)


def parent_of(path: str) -> str:
    norm = normalize_path(path)
    if norm == "/":
        return "/"
    return norm.rsplit("/", 1)[0] or "/"


def basename_of(path: str) -> str:
    norm = normalize_path(path)
    return norm.rsplit("/", 1)[1] if norm != "/" else "/"


class ClientRuntime:
    """Mixin providing fd bookkeeping and transactional op dispatch.

    ``WtfClient`` composes this with ``SliceOps`` and ``PosixOps``; the
    attributes referenced here (``kv``, ``stats``, ``_fds``, ...) are set up
    by ``WtfClient.__init__``.
    """

    MAX_RETRIES = 16

    # ------------------------------------------------------------ plumbing
    def _begin_txn(self):
        """Begin a KV transaction wired to this client's lease table (when
        the cluster runs leases) — every op/transaction/replay path MUST
        come through here so lease-served reads and the read-only commit
        skip apply uniformly, including op bodies on runtime pool threads
        (the lease table is thread-safe)."""
        txn = self.kv.begin()
        if self._lease_table is not None:
            txn.attach_leases(self._lease_table)
        return txn

    def _alloc_inode_id(self) -> int:
        # Unique without coordination (no read dependency on a counter →
        # creates never conflict with each other).
        return (self._client_id << 40) | next(self._id_counter)

    def _alloc_inode_id_for(self, path: str) -> int:
        """Allocate an inode id placed on the same metadata shard as
        ``path``, so the hot single-file transactions (open/read/write)
        stay single-shard by construction.  Identity on a 1-shard plane."""
        return self.kv.colocated_inode_id(path, self._alloc_inode_id())

    def _fd_state(self) -> dict:
        return {fd: f.snap() for fd, f in self._fds.items()}

    def _restore_fd_state(self, snap: dict) -> None:
        self._fds = {fd: _Fd.restore(t) for fd, t in snap.items()}

    def _get_fd(self, fd: int) -> _Fd:
        f = self._fds.get(fd)
        if f is None:
            raise BadFileDescriptor(f"fd {fd}")
        return f

    def _get_wfd(self, fd: int) -> _Fd:
        """Like ``_get_fd`` but the fd must be open for writing: write-side
        ops on an ``"r"`` fd raise instead of silently mutating the file."""
        f = self._get_fd(fd)
        if not f.writable:
            raise NotOpenForWriting(
                f"fd {fd} ({f.path!r}) is not open for writing")
        return f

    # ---------------------------------------------------- write-behind hooks
    def _write_behind_active(self) -> bool:
        """Whether slice creations of the op being executed should defer
        into the write-behind buffer (client knob or buffered handle)."""
        return self.write_behind or self._op_buffered

    def _flush_writeback(self, ctx: "_Ctx", ops=()) -> None:
        """Commit-boundary flush: store every deferred payload through the
        write scheduler in one pass, then resolve the recorded pending
        pointers everywhere they were captured — queued region commutes,
        op artifacts (so §2.6 replays reuse the batch pointers verbatim)
        and op digests.  Runs BEFORE the KV commit, preserving the
        slices-before-metadata invariant (§2.1) for the whole batch."""
        if not self._wb.pending:
            return
        from .inode import AppendExtents
        from .wbuf import resolve_value
        self._wb.flush(self.cluster, self.stats)

        def fix(cop):
            if isinstance(cop, AppendExtents):
                new = tuple(resolve_value(e) for e in cop.extents)
                if any(n is not o for n, o in zip(new, cop.extents)):
                    return AppendExtents(new, relative=cop.relative,
                                         bound=cop.bound)
            return cop

        ctx.txn.map_commutes(fix)
        for op in ops:
            op.artifacts = resolve_value(op.artifacts)
            op.digest = resolve_value(op.digest)

    # -------------------------------------------------------- txn dispatch
    def _release_handoffs(self, ops) -> None:
        """End-of-transaction ACK to the storage servers: every slice these
        ops created (recorded in their artifacts for §2.6 replay) has
        either been published by the commit or become plain garbage via
        the final abort — the tier-3 GC no longer needs to protect its
        create→commit handoff window.  Idempotent and exception-free."""
        ptrs = [p for op in ops
                for p in _iter_slice_pointers(op.artifacts)]
        if ptrs:
            self.cluster.release_slices(ptrs)

    def transaction(self) -> "WtfTransaction":
        """Begin a fully general multi-file transaction (§2.6)."""
        if self._txn is not None:
            raise WtfError("nested transactions are not supported")
        return WtfTransaction(self)

    def _run(self, name: str, *args, **kwargs) -> Any:
        if self._txn is not None:
            return self._txn._run(name, args, kwargs)
        # Auto-commit: single-op transaction with internal retry.  Nothing
        # is application-visible until we return, so retry is always safe.
        # A vectored op (readv/writev/yankv/pastev) is one op here, which is
        # what makes a whole batch atomic: either the entire batch commits
        # or the fd state and file contents are exactly as before.
        op = _Op(name, args, kwargs)
        fd_snap = self._fd_state()
        last: Optional[Exception] = None
        try:
            for attempt in range(self.MAX_RETRIES):
                if attempt:
                    self.stats.add(txn_retries=1)
                    self._restore_fd_state(fd_snap)
                ctx = _Ctx(self._begin_txn(), first=(attempt == 0))
                try:
                    result = self._exec(op, ctx)
                    # Write-behind (auto-commit scope): stores the op
                    # deferred flush here, in one scheduler pass, before
                    # the metadata commits.  Retries hit the op's resolved
                    # artifacts and leave the buffer empty.
                    self._flush_writeback(ctx, (op,))
                    ctx.txn.commit()
                    return result
                except (KVConflict, PreconditionFailed) as e:
                    last = e
                    continue
                except BaseException:
                    # Op body or flush failed outright: deferred payloads
                    # from the dead op must not leak into a later commit
                    # scope, and fd state the op advanced before failing
                    # rolls back.
                    self._wb.clear()
                    self._restore_fd_state(fd_snap)
                    raise
        finally:
            # Commit or final abort, the create→commit handoff is over:
            # un-shield this op's slices from the tier-3 GC.  Must run
            # after the LAST attempt, never between retries — replays
            # reuse the recorded pointers (§2.6).
            self._release_handoffs((op,))
        self.stats.add(txn_aborts=1)
        # the aborted op leaves no trace — including fd offsets the op
        # body advanced before its commit failed, and any deferred stores
        # a never-flushed attempt left in the write-behind buffer
        self._wb.clear()
        self._restore_fd_state(fd_snap)
        raise TransactionAborted(
            f"auto-commit op {name} failed after {self.MAX_RETRIES} "
            f"attempts: {last}")

    def _exec(self, op: _Op, ctx: _Ctx) -> Any:
        fn = getattr(self, f"_op_{op.name}")
        return fn(ctx, op, *op.args, **op.kwargs)


class WtfTransaction:
    """Fully general multi-file transaction with the §2.6 retry layer.

    Every application call is logged with its arguments and app-visible
    outcome digest.  On a HyperDex-level abort (KVConflict /
    PreconditionFailed) the filesystem is unchanged, so the whole op log is
    replayed with the original arguments; if any replayed call's outcome
    differs from what the application already observed, the transaction
    aborts to the application — otherwise the replay commits invisibly.
    """

    MAX_RETRIES = 16

    def __init__(self, client):
        self.client = client
        self._ops: list[_Op] = []
        self._ctx: Optional[_Ctx] = None
        self._fd_snap: Optional[dict] = None
        self._done = False

    # -- context manager ------------------------------------------------
    def __enter__(self) -> "WtfTransaction":
        if self.client._txn is not None:
            raise WtfError("client already has an open transaction")
        self.client._txn = self
        self._fd_snap = self.client._fd_state()
        self._ctx = _Ctx(self.client._begin_txn(), first=True)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            if exc_type is None and not self._done:
                self.commit()
            elif not self._done:
                self.abort()
        finally:
            self.client._txn = None
        return False

    # -- op dispatch -------------------------------------------------------
    def _run(self, name: str, args: tuple, kwargs: dict) -> Any:
        if self._done:
            raise WtfError("transaction already finished")
        op = _Op(name, args, kwargs)
        result = self.client._exec(op, self._ctx)
        op.digest = _digest(result)
        self._ops.append(op)
        return result

    # -- commit / abort -----------------------------------------------------
    def commit(self) -> None:
        if self._done:
            raise WtfError("transaction already finished")
        # Write-behind: every op's deferred stores flush as ONE scheduler
        # planning pass (cross-op coalescing + per-region fan-out); the
        # metadata commit only proceeds once every slice is durable
        # (§2.1).  Replays reuse the resolved artifacts, so retries never
        # re-store data.
        self._flush_or_abort()
        last: Optional[Exception] = None
        try:
            for attempt in range(self.MAX_RETRIES):
                if attempt:
                    self.client.stats.add(txn_retries=1)
                    try:
                        self._replay()
                    except (KVConflict, PreconditionFailed) as e:
                        last = e
                        continue
                    # Normally a no-op: replays hit the resolved artifact
                    # cache.  If a replayed op took a branch that planned a
                    # NEW store, it must flush before the commit too.
                    self._flush_or_abort()
                try:
                    self._ctx.txn.commit()
                    self._done = True
                    return
                except (KVConflict, PreconditionFailed) as e:
                    last = e
        finally:
            # The transaction is over either way (commit, divergent
            # replay, or give-up below): release the GC handoff shield on
            # every slice the op log created.
            self.client._release_handoffs(self._ops)
        self._done = True
        self.client.stats.add(txn_aborts=1)
        self.client._wb.clear()
        self.client._restore_fd_state(self._fd_snap)
        raise TransactionAborted(
            f"gave up after {self.MAX_RETRIES} replays: {last}")

    def _flush_or_abort(self) -> None:
        """Run the write-behind flush; on ANY failure (e.g. StorageError
        when every replica candidate refused) abort the transaction
        wholesale: the KV transaction never commits, so nothing becomes
        visible and partially created slices are unreferenced garbage for
        the tier-3 GC."""
        try:
            self.client._flush_writeback(self._ctx, self._ops)
        except BaseException:
            self._done = True
            self.client._wb.clear()
            self.client.stats.add(txn_aborts=1)
            try:
                self._ctx.txn.abort()
            finally:
                self.client._restore_fd_state(self._fd_snap)
                self.client._release_handoffs(self._ops)
            raise

    def _replay(self) -> None:
        """Re-execute the op log against a fresh KV transaction (§2.6)."""
        self.client._restore_fd_state(self._fd_snap)
        self._ctx = _Ctx(self.client._begin_txn(), first=False)
        for op in self._ops:
            try:
                result = self.client._exec(op, self._ctx)
            except (KVConflict, PreconditionFailed):
                raise
            except WtfError as e:
                # The op succeeded on first execution but errors on replay
                # (e.g. a validity check now fails against changed state):
                # that is a divergent application-visible outcome (§2.6).
                result = e
            if _digest(result) != op.digest:
                self._done = True
                self.client.stats.add(txn_aborts=1)
                # the transaction leaves no trace — including fd offsets
                # and deferred stores replayed ops queued before diverging
                self.client._wb.clear()
                self.client._restore_fd_state(self._fd_snap)
                raise TransactionAborted(
                    f"replayed {op.name} produced a different "
                    f"application-visible outcome")

    def abort(self) -> None:
        self._ctx.txn.abort()
        # Deferred stores were never dispatched: aborting a write-behind
        # transaction leaves zero storage-server garbage.
        self.client._wb.clear()
        self.client._restore_fd_state(self._fd_snap)
        # Eagerly-stored slices ARE garbage now — hand them to the GC.
        self.client._release_handoffs(self._ops)
        self._done = True
