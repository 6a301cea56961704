"""POSIX-style surface — the top layer of the split client (see
``client.py`` for how the layers assemble).

Scalar surface: open/close/read/write/pread/pwrite/seek/tell/truncate,
mkdir/listdir, link/unlink/rmdir/rename/stat — with one-lookup open (§2.4).

Vectored surface (the handle-based I/O redesign):

  * ``readv(fd, ranges)``   — fetch many ``(offset, length)`` ranges in one
    transaction; slice fetches for *all* ranges are planned together and
    handed to the batched scheduler, so adjacent/near-adjacent pointers
    coalesce into single storage rounds and distinct servers are read in
    parallel.  Positional: the fd offset does not move.
  * ``preadv(fd, sizes, offset)`` — POSIX flavor: consecutive chunks
    starting at ``offset``.
  * ``writev(fd, chunks)``  — gather-write at the fd offset; all chunk
    stores are planned first and dispatched through the write scheduler
    (``wsched``): chunks within one region coalesce into a single covering
    store, regions fan out across distinct servers in parallel.
  * ``pwritev(fd, chunks, offset)`` — positional gather-write.

Each vectored call executes as a single logged op inside one transaction, so
a batch is atomic: all of it commits or none of it is visible.  Prefer
``WtfClient.open_file`` / ``WtfFile`` (``handle.py``) over raw fd juggling.

Async surface (the unified I/O runtime's futures flavor):

  * ``readv_async`` / ``preadv_async`` / ``writev_async`` /
    ``pwritev_async`` mirror their synchronous twins but return an
    ``IoFuture``: the op body (metadata planning + data rounds + commit)
    runs on the cluster's ``IoRuntime`` pool, so the caller can plan op
    N+1 while op N's data rounds are in flight.  Everything fd-dependent
    resolves at submission on the calling thread (EBADF/EINVAL fail fast;
    ``writev_async`` advances the fd offset eagerly, like POSIX AIO);
    each op then commits as its own auto-commit transaction on the
    worker.  Async ops are auto-commit only — inside an open
    ``WtfTransaction`` they raise, because the §2.6 op log is ordered by
    the application thread.  With write-behind active, async writes
    complete synchronously into the buffer (there is no storage round to
    overlap) and return an already-resolved future.


Directories are special files (§2.4): their content is a record log of
add/del entries, maintained with the same append machinery as data.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.util import jsonio

from .client_runtime import (SEEK_CUR, SEEK_END, SEEK_SET, _Ctx, _Fd, _Op,
                             basename_of, normalize_path, parent_of)
from .errors import (AlreadyExists, DirectoryNotEmpty, InvalidOffset,
                     IsADirectory, NotADirectory, NotFound, WtfError)
from .inode import AppendExtents, Inode, region_key
from .iort import IoFuture
from .slicing import Extent


class PosixOps:
    """Mixin: POSIX surface + directory machinery for ``WtfClient``."""

    # ===================================================== public API: POSIX
    def mkfs(self) -> None:
        """Create the root directory and GC directory (idempotent)."""
        from .client import GC_DIR
        txn = self._begin_txn()
        if txn.get("paths", "/") is None:
            root = Inode(self._alloc_inode_id_for("/"), "dir",
                         mtime=self.time_fn(),
                         region_size=self.cluster.region_size)
            txn.put("paths", "/", root.inode_id)
            txn.put("inodes", root.inode_id, root)
            txn.commit()
            self.mkdir(GC_DIR)
        else:
            txn.abort()

    def open(self, path: str, mode: str = "r",
             region_size: Optional[int] = None) -> int:
        """One-lookup open (§2.4): pathname → inode in a single KV get."""
        return self._run("open", normalize_path(path), mode, region_size)

    def open_file(self, path: str, mode: str = "r",
                  region_size: Optional[int] = None,
                  buffered: bool = False):
        """Open ``path`` as a first-class ``WtfFile`` handle (context
        manager) — the preferred surface over raw integer fds.
        ``buffered=True`` opts this handle's writes into the write-behind
        buffer even when the client/cluster knob is off (they flush at the
        enclosing commit boundary)."""
        from .handle import WtfFile
        fd = self.open(path, mode, region_size)
        return WtfFile(self, fd, normalize_path(path), mode,
                       buffered=buffered)

    def close(self, fd: int) -> None:
        self._get_fd(fd)
        del self._fds[fd]

    def read(self, fd: int, size: int = -1) -> bytes:
        return self._run("read", fd, size)

    def pread(self, fd: int, size: int, offset: int) -> bytes:
        return self._run("pread", fd, size, offset)

    def write(self, fd: int, data: bytes) -> int:
        return self._run("write", fd, bytes(data))

    def pwrite(self, fd: int, data: bytes, offset: int) -> int:
        return self._run("pwrite", fd, bytes(data), offset)

    # ------------------------------------------------- vectored POSIX API
    def readv(self, fd: int,
              ranges: Sequence[Tuple[int, int]]) -> List[bytes]:
        """Read many ``(offset, length)`` ranges as one atomic batch.

        Returns one ``bytes`` per range (clamped at end-of-file exactly like
        ``pread``).  All ranges are planned in a single transaction and
        fetched through the batched scheduler — at most one storage round
        per (server, backing-file) run of coalescible pointers."""
        return self._run("readv", fd,
                         tuple((int(o), int(n)) for o, n in ranges))

    def preadv(self, fd: int, sizes: Sequence[int],
               offset: int) -> List[bytes]:
        """POSIX-flavor vectored read: consecutive chunks of the given sizes
        starting at ``offset``.  The fd offset does not move."""
        ranges = []
        pos = offset
        for sz in sizes:
            ranges.append((pos, int(sz)))
            pos += int(sz)
        return self._run("readv", fd, tuple(ranges))

    def writev(self, fd: int, chunks: Sequence[bytes]) -> int:
        """Gather-write ``chunks`` at the fd offset as one atomic batch;
        advances the offset and returns the total byte count.  Stores are
        planned for the whole batch before dispatch: chunks in one region
        coalesce into a single covering store (one round instead of one per
        chunk), chunks in different regions store in parallel."""
        return self._run("writev", fd, tuple(bytes(c) for c in chunks))

    def pwritev(self, fd: int, chunks: Sequence[bytes],
                offset: int) -> int:
        """Positional gather-write at ``offset``; the fd offset is
        untouched."""
        return self._run("pwritev", fd, tuple(bytes(c) for c in chunks),
                         offset)

    # ------------------------------------------------- async POSIX surface
    def _check_async_scope(self) -> None:
        """Async ops are auto-commit only (the §2.6 op log is
        single-threaded).  Checked BEFORE any submission-time state
        mutation — ``writev_async``'s eager offset advance must not happen
        if the call is about to be rejected."""
        if self._txn is not None:
            raise WtfError(
                "async ops are auto-commit only: they cannot join an "
                "open transaction's op log")

    def _submit_async(self, body, *args) -> IoFuture:
        self._check_async_scope()
        self.stats.add(async_ops=1)
        return self.cluster.runtime.submit_op(
            lambda: body(*args), stats=self.stats)

    def readv_async(self, fd: int,
                    ranges: Sequence[Tuple[int, int]]) -> IoFuture:
        """``readv`` returning an ``IoFuture`` of the range list.

        fd resolution and EINVAL checks happen now, on the calling thread;
        planning and fetching run on a runtime worker *at execution time*,
        so a commit landing before the future runs invalidates any cached
        plan (region versions moved) and the read re-plans against the
        committed state — never stale extents.  Positional: the fd offset
        does not move."""
        f = self._get_fd(fd)          # EBADF before EINVAL, like POSIX
        ranges = tuple((int(o), int(n)) for o, n in ranges)
        for off, size in ranges:
            if off < 0 or size < 0:
                raise InvalidOffset(
                    f"negative range ({off}, {size}) in vectored read plan")
        return self._submit_async(self._async_readv_body, f.inode_id, ranges)

    def preadv_async(self, fd: int, sizes: Sequence[int],
                     offset: int) -> IoFuture:
        """POSIX-flavor async vectored read: consecutive chunks starting at
        ``offset``; the fd offset does not move."""
        if offset < 0:
            self._get_fd(fd)          # EBADF first
            raise InvalidOffset(f"preadv at negative offset {offset}")
        ranges = []
        pos = offset
        for sz in sizes:
            ranges.append((pos, int(sz)))
            pos += int(sz)
        return self.readv_async(fd, ranges)

    def writev_async(self, fd: int, chunks: Sequence[bytes]) -> IoFuture:
        """Gather-write returning an ``IoFuture`` of the byte count.

        The fd offset advances eagerly at submission (POSIX-AIO style), so
        the caller can keep issuing ordered writes; stores and the
        metadata commit run on a worker.  A failed future leaves the
        offset advanced — callers that care re-seek, exactly as with
        ``aio_write``."""
        self._check_async_scope()     # before the eager offset mutation
        f = self._get_wfd(fd)
        chunks = tuple(bytes(c) for c in chunks)
        if f.append:
            # O_APPEND fds cannot pin an offset at submission — the EOF
            # is resolved at commit time.  Run the relative append inline
            # and hand back an already-resolved future.
            self.stats.add(async_ops=1)
            return IoFuture.resolved(self._run("writev", fd, chunks))
        offset = f.offset
        f.offset += sum(len(c) for c in chunks)
        return self._async_write(f, chunks, offset)

    def pwritev_async(self, fd: int, chunks: Sequence[bytes],
                      offset: int) -> IoFuture:
        """Positional async gather-write; the fd offset is untouched."""
        f = self._get_wfd(fd)         # EBADF before EINVAL, like POSIX
        if offset < 0:
            raise InvalidOffset(f"pwritev at negative offset {offset}")
        chunks = tuple(bytes(c) for c in chunks)
        return self._async_write(f, chunks, offset)

    def _async_write(self, f, chunks: Tuple[bytes, ...],
                     offset: int) -> IoFuture:
        if self._write_behind_active():
            # Deferred stores never touch a storage server until the
            # commit flush — there is nothing to overlap, and the buffer
            # belongs to the application thread.  Complete synchronously.
            self._check_async_scope()
            self.stats.add(async_ops=1)
            return IoFuture.resolved(
                self._run("pwritev", f.fd, chunks, offset))
        return self._submit_async(self._async_pwritev_body, f.inode_id,
                                  chunks, offset)

    def seek(self, fd: int, offset: int, whence: int = SEEK_SET):
        return self._run("seek", fd, offset, whence)

    def tell(self, fd: int) -> int:
        return self._get_fd(fd).offset

    def truncate(self, fd: int, length: int = 0) -> None:
        return self._run("truncate", fd, length)

    def mkdir(self, path: str) -> None:
        return self._run("mkdir", normalize_path(path))

    def listdir(self, path: str) -> list[str]:
        return self._run("listdir", normalize_path(path))

    def link(self, existing: str, new: str) -> None:
        """Hardlink: atomically add the path→inode mapping, bump the link
        count, and append the dirent — the paper's own example txn (§2.4)."""
        return self._run("link", normalize_path(existing), normalize_path(new))

    def unlink(self, path: str) -> None:
        return self._run("unlink", normalize_path(path))

    def rmdir(self, path: str) -> None:
        return self._run("rmdir", normalize_path(path))

    def rename(self, old: str, new: str) -> None:
        return self._run("rename", normalize_path(old), normalize_path(new))

    def stat(self, path: str) -> dict:
        return self._run("stat", normalize_path(path))

    def exists(self, path: str) -> bool:
        return self.kv.get("paths", normalize_path(path)) is not None

    def file_length(self, path: str) -> int:
        return self.stat(path)["size"]

    # ============================================================ op bodies
    # Each _op_* body executes against a WarpKV transaction and must be
    # replayable: artifacts created on first execution (slices, ids) are
    # recorded on the op and reused verbatim on replay (§2.6: the log keeps
    # slice pointers, never data).

    def _op_open(self, ctx: _Ctx, op: _Op, path: str, mode: str,
                 region_size: Optional[int]) -> int:
        create = "w" in mode or "a" in mode or "x" in mode
        ino_id = ctx.txn.get("paths", path)
        if ino_id is None:
            if not create:
                raise NotFound(path)
            ino_id = self._create_file(ctx, op, path, region_size)
            ino = ctx.txn.get("inodes", ino_id)
        else:
            if "x" in mode:
                raise AlreadyExists(path)
            ino = ctx.txn.get("inodes", ino_id)
            if ino is None:
                raise NotFound(f"dangling path {path}")
            if ino.kind == "dir" and ("w" in mode or "a" in mode):
                raise IsADirectory(path)
            if mode == "w":                       # truncate semantics
                # view inode: regions grown by writes queued earlier in
                # THIS transaction must be truncated too
                self._truncate_inode(ctx, self._inode(ctx, ino_id), 0)
        f = _Fd(op.artifacts.setdefault("fd", next(self._fd_counter)),
                ino_id, path, writable=("r" != mode))
        if "a" in mode:
            # O_APPEND: the offset is advisory (tell/read); writes are
            # routed to the file's current EOF at commit time, never to
            # this snapshot — concurrent appenders from other clients may
            # move the EOF between our writes.
            f.append = True
            f.offset = self._file_length(ctx, ino)
        self._fds[f.fd] = f
        return f.fd

    def _create_file(self, ctx: _Ctx, op: _Op, path: str,
                     region_size: Optional[int]) -> int:
        parent = parent_of(path)
        parent_id = ctx.txn.get("paths", parent)
        if parent_id is None:
            raise NotFound(f"parent directory {parent}")
        pino = ctx.txn.get("inodes", parent_id)
        if pino.kind != "dir":
            raise NotADirectory(parent)
        ino_id = op.artifacts.setdefault(
            "ino", self._alloc_inode_id_for(path))
        now = op.artifacts.setdefault("mtime", self.time_fn())
        ino = Inode(ino_id, "file", mtime=now,
                    region_size=region_size or self.cluster.region_size)
        ctx.txn.put("paths", path, ino_id)
        ctx.txn.put("inodes", ino_id, ino)
        self._dir_append(ctx, op, pino, {"op": "add",
                                         "name": basename_of(path),
                                         "ino": ino_id})
        return ino_id

    def _op_read(self, ctx: _Ctx, op: _Op, fd: int, size: int) -> bytes:
        f = self._get_fd(fd)
        ino = self._inode(ctx, f.inode_id)
        length = self._file_length(ctx, ino)
        if size < 0:
            size = max(0, length - f.offset)
        size = min(size, max(0, length - f.offset))
        data = self._read_range(ctx, ino, f.offset, size)
        f.offset += len(data)
        self.stats.add(logical_bytes_read=len(data))
        return data

    def _op_pread(self, ctx: _Ctx, op: _Op, fd: int, size: int,
                  offset: int) -> bytes:
        f = self._get_fd(fd)          # EBADF before EINVAL, like POSIX
        if offset < 0:
            raise InvalidOffset(f"pread at negative offset {offset}")
        ino = self._inode(ctx, f.inode_id)
        length = self._file_length(ctx, ino)
        size = min(size, max(0, length - offset))
        data = self._read_range(ctx, ino, offset, size)
        self.stats.add(logical_bytes_read=len(data))
        return data

    def _op_readv(self, ctx: _Ctx, op: _Op, fd: int,
                  ranges: Tuple[Tuple[int, int], ...]) -> List[bytes]:
        f, plans = self._clamped_plans(ctx, fd, ranges)
        out = self._fetch_many(plans, inode_id=f.inode_id)
        self.stats.add(logical_bytes_read=sum(len(b) for b in out),
                       vectored_ops=1)
        return out

    def _op_write(self, ctx: _Ctx, op: _Op, fd: int, data: bytes) -> int:
        f = self._get_wfd(fd)
        if f.append:
            # O_APPEND: land at the CURRENT end of file, atomically.  A
            # positional write at the fd's cached offset would silently
            # overwrite concurrent appenders that opened at the same EOF;
            # the §2.5 relative append makes them commute instead.
            n = self._append_fd(ctx, op, f, data)
        else:
            n = self._write_at(ctx, op, f.inode_id, f.offset, data,
                               key="w")
        f.offset += n
        return n

    def _op_pwrite(self, ctx: _Ctx, op: _Op, fd: int, data: bytes,
                   offset: int) -> int:
        f = self._get_wfd(fd)         # EBADF before EINVAL, like POSIX
        if offset < 0:
            raise InvalidOffset(f"pwrite at negative offset {offset}")
        return self._write_at(ctx, op, f.inode_id, offset, data, key="w")

    def _op_writev(self, ctx: _Ctx, op: _Op, fd: int,
                   chunks: Tuple[bytes, ...]) -> int:
        f = self._get_wfd(fd)
        if f.append:
            # O_APPEND gather-write: the whole batch is one contiguous
            # relative append (chunks stay adjacent, like writev's
            # single-offset contract).
            n = self._append_fd(ctx, op, f, b"".join(chunks))
        else:
            n = self._writev_at(ctx, op, f.inode_id, f.offset, chunks,
                                key="wv")
        f.offset += n
        self.stats.add(vectored_ops=1)
        return n

    def _op_pwritev(self, ctx: _Ctx, op: _Op, fd: int,
                    chunks: Tuple[bytes, ...], offset: int) -> int:
        f = self._get_wfd(fd)         # EBADF before EINVAL, like POSIX
        if offset < 0:
            raise InvalidOffset(f"pwritev at negative offset {offset}")
        n = self._writev_at(ctx, op, f.inode_id, offset, chunks, key="wv")
        self.stats.add(vectored_ops=1)
        return n

    def _op_seek(self, ctx: _Ctx, op: _Op, fd: int, offset: int,
                 whence: int):
        f = self._get_fd(fd)
        if whence == SEEK_SET:
            if offset < 0:
                raise InvalidOffset(f"seek to negative offset {offset}")
            f.offset = offset
            return f.offset
        if whence == SEEK_CUR:
            if f.offset + offset < 0:
                raise InvalidOffset(
                    f"seek to negative offset {f.offset + offset}")
            f.offset += offset
            return f.offset
        if whence == SEEK_END:
            ino = self._inode(ctx, f.inode_id)
            new = self._file_length(ctx, ino) + offset
            if new < 0:
                raise InvalidOffset(f"seek to negative offset {new}")
            f.offset = new
            # The application never observes the end-of-file offset through
            # seek — that's precisely what makes seek(END)+write retryable
            # without an application-visible conflict (§2.6).
            return None
        raise WtfError(f"bad whence {whence}")

    def _op_truncate(self, ctx: _Ctx, op: _Op, fd: int, length: int) -> None:
        f = self._get_wfd(fd)
        ino = self._inode(ctx, f.inode_id)
        self._truncate_inode(ctx, ino, length)

    def _op_mkdir(self, ctx: _Ctx, op: _Op, path: str) -> None:
        if ctx.txn.get("paths", path) is not None:
            raise AlreadyExists(path)
        parent = parent_of(path)
        parent_id = ctx.txn.get("paths", parent)
        if parent_id is None:
            raise NotFound(f"parent directory {parent}")
        pino = ctx.txn.get("inodes", parent_id)
        if pino.kind != "dir":
            raise NotADirectory(parent)
        ino_id = op.artifacts.setdefault(
            "ino", self._alloc_inode_id_for(path))
        now = op.artifacts.setdefault("mtime", self.time_fn())
        ino = Inode(ino_id, "dir", mtime=now,
                    region_size=self.cluster.region_size)
        ctx.txn.put("paths", path, ino_id)
        ctx.txn.put("inodes", ino_id, ino)
        self._dir_append(ctx, op, pino,
                         {"op": "add", "name": basename_of(path),
                          "ino": ino_id})

    def _op_listdir(self, ctx: _Ctx, op: _Op, path: str) -> list[str]:
        ino = self._inode_at(ctx, path)
        if ino.kind != "dir":
            raise NotADirectory(path)
        return sorted(self._dir_entries(ctx, ino).keys())

    def _op_link(self, ctx: _Ctx, op: _Op, existing: str, new: str) -> None:
        from .inode import BumpInode
        ino_id = ctx.txn.get("paths", existing)
        if ino_id is None:
            raise NotFound(existing)
        if ctx.txn.get("paths", new) is not None:
            raise AlreadyExists(new)
        parent_id = ctx.txn.get("paths", parent_of(new))
        if parent_id is None:
            raise NotFound(parent_of(new))
        pino = ctx.txn.get("inodes", parent_id)
        # Atomically: new mapping + link count + dirent (§2.4).
        ctx.txn.put("paths", new, ino_id)
        ctx.txn.commute("inodes", ino_id, BumpInode(link_delta=1))
        self._dir_append(ctx, op, pino,
                         {"op": "add", "name": basename_of(new),
                          "ino": ino_id})

    def _op_unlink(self, ctx: _Ctx, op: _Op, path: str) -> None:
        ino_id = ctx.txn.get("paths", path)
        if ino_id is None:
            raise NotFound(path)
        ino = ctx.txn.get("inodes", ino_id)
        if ino.kind == "dir":
            raise IsADirectory(path)
        parent_id = ctx.txn.get("paths", parent_of(path))
        pino = ctx.txn.get("inodes", parent_id)
        ctx.txn.delete("paths", path)
        self._dir_append(ctx, op, pino,
                         {"op": "del", "name": basename_of(path)})
        if ino.links <= 1:
            # Last link: drop the inode and all region metadata; the slices
            # become garbage for the tier-3 collector (§2.8).
            ctx.txn.delete("inodes", ino_id)
            for r in range(ino.max_region + 1):
                ctx.txn.delete("regions", region_key(ino_id, r))
        else:
            ctx.txn.put("inodes", ino_id, ino.replace(links=ino.links - 1))

    def _op_rmdir(self, ctx: _Ctx, op: _Op, path: str) -> None:
        if path == "/":
            raise WtfError("cannot remove the root directory")
        ino_id = ctx.txn.get("paths", path)
        if ino_id is None:
            raise NotFound(path)
        ino = ctx.txn.get("inodes", ino_id)
        if ino.kind != "dir":
            raise NotADirectory(path)
        if self._dir_entries(ctx, ino):
            raise DirectoryNotEmpty(path)
        parent_id = ctx.txn.get("paths", parent_of(path))
        pino = ctx.txn.get("inodes", parent_id)
        ctx.txn.delete("paths", path)
        ctx.txn.delete("inodes", ino_id)
        ctx.txn.delete("regions", region_key(ino_id, 0))
        self._dir_append(ctx, op, pino,
                         {"op": "del", "name": basename_of(path)})

    def _op_rename(self, ctx: _Ctx, op: _Op, old: str, new: str) -> None:
        ino_id = ctx.txn.get("paths", old)
        if ino_id is None:
            raise NotFound(old)
        if ctx.txn.get("paths", new) is not None:
            raise AlreadyExists(new)
        ino = ctx.txn.get("inodes", ino_id)
        if ino.kind == "dir" and (new + "/").startswith(old + "/"):
            # Renaming a directory into its own subtree would orphan the
            # whole subtree behind an unreachable path (a cycle in POSIX
            # terms: rename(2) reports EINVAL for this).
            raise WtfError(
                f"cannot rename directory {old} into its own subtree {new}")
        old_pid = ctx.txn.get("paths", parent_of(old))
        new_pid = ctx.txn.get("paths", parent_of(new))
        if new_pid is None:
            raise NotFound(parent_of(new))
        new_pino = ctx.txn.get("inodes", new_pid)
        if new_pino is None or new_pino.kind != "dir":
            # e.g. rename into "/some/file.txt/x": the dirent must never be
            # appended into a regular file's data (ENOTDIR).
            raise NotADirectory(parent_of(new))
        ctx.txn.delete("paths", old)
        ctx.txn.put("paths", new, ino_id)
        self._dir_append(ctx, op, ctx.txn.get("inodes", old_pid),
                         {"op": "del", "name": basename_of(old)}, key="d1")
        self._dir_append(ctx, op, ctx.txn.get("inodes", new_pid),
                         {"op": "add", "name": basename_of(new),
                          "ino": ino_id}, key="d2")

    def _op_stat(self, ctx: _Ctx, op: _Op, path: str) -> dict:
        ino = self._inode_at(ctx, path)
        return {
            "inode": ino.inode_id,
            "kind": ino.kind,
            "links": ino.links,
            "mtime": ino.mtime,
            "mode": ino.mode,
            "size": self._file_length(ctx, ino),
            "region_size": ino.region_size,
        }

    # ----------------------------------------------------------- dir files
    # Directories are special files (§2.4): their content is a record log of
    # add/del entries, maintained with the same append machinery as data.
    def _dir_append(self, ctx: _Ctx, op: _Op, dir_ino: Inode, record: dict,
                    key: str = "d") -> None:
        data = jsonio.dumps(record) + b"\n"
        full = self._data_slice(ctx, op, dir_ino, 0, data, key=key)
        # routes through the compaction-aware append: a busy directory's
        # record log is exactly the hot-region small-append stream the
        # commit-time compaction threshold exists to bound
        self._commute_region_append(
            ctx, dir_ino.inode_id, 0,
            AppendExtents([Extent(0, len(data), full.ptrs)],
                          relative=True, bound=dir_ino.region_size))
        self._bump(ctx, dir_ino.inode_id, op, max_region=0)

    def _dir_entries(self, ctx: _Ctx, dir_ino: Inode) -> dict[str, int]:
        length = self._file_length(ctx, dir_ino)
        raw = self._read_range(ctx, dir_ino, 0, length)
        entries: dict[str, int] = {}
        for line in raw.split(b"\n"):
            if not line.strip(b"\x00"):
                continue
            rec = jsonio.loads(line)
            if rec["op"] == "add":
                entries[rec["name"]] = rec["ino"]
            else:
                entries.pop(rec["name"], None)
        return entries
