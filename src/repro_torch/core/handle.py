"""First-class file handles: ``WtfFile``.

Raw integer fds force call sites to thread ``(client, fd)`` pairs around and
to remember ``close`` on every path (TxForest, arXiv 1908.10273, makes the
case for typed handles over raw fds).  ``WtfFile`` wraps the pair as a
context manager carrying the full scalar + vectored I/O surface; it is what
``WtfClient.open_file`` returns and what the internal consumers
(checkpointing, data pipeline, benchmarks) use instead of fd juggling.

The handle adds no transactional semantics of its own: every method
delegates to the owning client, so a handle used inside
``client.transaction()`` participates in that transaction like any other
call.

``buffered=True`` (``open_file(path, mode, buffered=True)``) opts the
handle's data-writing calls into the client's write-behind buffer even when
the ``Cluster(write_behind=...)`` knob is off: payloads are recorded as
pending stores and flush in one scheduled pass at the enclosing commit
boundary — the surrounding ``WtfTransaction``'s commit, or the auto-commit
of each op.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from .slicing import Extent


class WtfFile:
    """A file handle bound to one ``WtfClient`` fd.  Not thread-safe (one
    client per thread, per the client library's contract)."""

    __slots__ = ("client", "fd", "path", "mode", "buffered", "_closed")

    def __init__(self, client, fd: int, path: str, mode: str,
                 buffered: bool = False):
        self.client = client
        self.fd = fd
        self.path = path
        self.mode = mode
        self.buffered = buffered
        self._closed = False

    def _buffered_call(self, fn, *args):
        """Run a data-writing client call with the write-behind flag raised
        when this handle opted in (restores the client's flag after)."""
        if not self.buffered:
            return fn(*args)
        c = self.client
        prev = c._op_buffered
        c._op_buffered = True
        try:
            return fn(*args)
        finally:
            c._op_buffered = prev

    # ------------------------------------------------------------- lifecycle
    def __enter__(self) -> "WtfFile":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    def close(self) -> None:
        if not self._closed:
            self.client.close(self.fd)
            self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def __repr__(self) -> str:
        state = "closed" if self._closed else f"fd={self.fd}"
        buf = " buffered" if self.buffered else ""
        return f"<WtfFile {self.path!r} mode={self.mode!r} {state}{buf}>"

    # ------------------------------------------------------------ scalar I/O
    def read(self, size: int = -1) -> bytes:
        return self.client.read(self.fd, size)

    def pread(self, size: int, offset: int) -> bytes:
        return self.client.pread(self.fd, size, offset)

    def write(self, data: bytes) -> int:
        return self._buffered_call(self.client.write, self.fd, data)

    def pwrite(self, data: bytes, offset: int) -> int:
        return self._buffered_call(self.client.pwrite, self.fd, data,
                                   offset)

    def append(self, data: bytes) -> int:
        return self._buffered_call(self.client.append, self.fd, data)

    def seek(self, offset: int, whence: int = 0):
        return self.client.seek(self.fd, offset, whence)

    def tell(self) -> int:
        return self.client.tell(self.fd)

    def truncate(self, length: int = 0) -> None:
        return self.client.truncate(self.fd, length)

    def size(self) -> int:
        return self.client.stat(self.path)["size"]

    # ---------------------------------------------------------- vectored I/O
    def readv(self, ranges: Sequence[Tuple[int, int]]) -> List[bytes]:
        return self.client.readv(self.fd, ranges)

    def preadv(self, sizes: Sequence[int], offset: int) -> List[bytes]:
        return self.client.preadv(self.fd, sizes, offset)

    def writev(self, chunks: Sequence[bytes]) -> int:
        return self._buffered_call(self.client.writev, self.fd, chunks)

    def pwritev(self, chunks: Sequence[bytes], offset: int) -> int:
        return self._buffered_call(self.client.pwritev, self.fd, chunks,
                                   offset)

    # ----------------------------------------------------------- async I/O
    # Futures flavor (``IoFuture``): the op runs on the cluster's unified
    # I/O runtime, so the caller overlaps its next op's planning with this
    # op's data rounds.  See ``posix_ops`` for the submission semantics.
    def readv_async(self, ranges: Sequence[Tuple[int, int]]):
        return self.client.readv_async(self.fd, ranges)

    def preadv_async(self, sizes: Sequence[int], offset: int):
        return self.client.preadv_async(self.fd, sizes, offset)

    def writev_async(self, chunks: Sequence[bytes]):
        return self._buffered_call(self.client.writev_async, self.fd,
                                   chunks)

    def pwritev_async(self, chunks: Sequence[bytes], offset: int):
        return self._buffered_call(self.client.pwritev_async, self.fd,
                                   chunks, offset)

    # --------------------------------------------------------------- slicing
    def yank(self, size: int, want_data: bool = False):
        return self.client.yank(self.fd, size, want_data)

    def yankv(self, ranges: Sequence[Tuple[int, int]]
              ) -> List[Tuple[Extent, ...]]:
        return self.client.yankv(self.fd, ranges)

    def paste(self, extents: Sequence[Extent]) -> int:
        return self.client.paste(self.fd, extents)

    def pastev(self, batches: Sequence[Sequence[Extent]]) -> int:
        return self.client.pastev(self.fd, batches)

    def punch(self, amount: int) -> int:
        return self.client.punch(self.fd, amount)

    def append_slices(self, extents: Sequence[Extent]) -> int:
        return self.client.append_slices(self.fd, extents)
