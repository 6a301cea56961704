"""Record-oriented files on WTF.

Training shards are files of *fixed-size records* (a record = ``block_size``
int32 tokens, or an arbitrary payload for the sort benchmark).  Fixed framing
is what makes the slicing API shine: any record's byte range is computable,
so datasets can be shuffled, mixed, and re-sharded with ``yank``/``paste`` —
pure metadata operations that move zero data bytes (the paper's sort
pipeline, §4.1, applied to training data).

Built on the handle-based vectored client API: a ``RecordFile`` owns a
``WtfFile`` and exposes batched record access (``read_records_batch``,
``yank_record_runs``) that turns N scattered record touches into one
transaction whose slice fetches are coalesced by the I/O scheduler.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import Extent, WtfClient


@dataclass(frozen=True)
class RecordSpec:
    record_bytes: int          # fixed record size in bytes
    count: int                 # number of records in the file


class RecordWriter:
    """Sequentially append fixed-size records to a WTF file."""

    def __init__(self, client: WtfClient, path: str, record_bytes: int):
        self.client = client
        self.path = path
        self.record_bytes = record_bytes
        self._f = client.open_file(path, "w")
        self._count = 0

    def append(self, payload: bytes) -> int:
        if len(payload) != self.record_bytes:
            raise ValueError(
                f"record must be exactly {self.record_bytes} bytes, "
                f"got {len(payload)}")
        self._f.append(payload)
        self._count += 1
        return self._count - 1

    def append_many(self, payloads: Sequence[bytes]) -> int:
        """Gather-append a batch of records as ONE atomic append op.

        The joined batch goes through the client's §2.5 relative-append
        path, so it is a single transaction (all-or-nothing) and remains
        safe under concurrent appenders — unlike a seek(END)+write pair.
        Returns the index of the last appended record (-1 if the writer
        is still empty)."""
        for p in payloads:
            if len(p) != self.record_bytes:
                raise ValueError(
                    f"record must be exactly {self.record_bytes} bytes, "
                    f"got {len(p)}")
        if payloads:
            self._f.append(b"".join(payloads))
            self._count += len(payloads)
        return self._count - 1

    def append_array(self, tokens: np.ndarray) -> int:
        return self.append(np.ascontiguousarray(tokens).tobytes())

    def close(self) -> RecordSpec:
        self._f.close()
        return RecordSpec(self.record_bytes, self._count)


class RecordFile:
    """Random and sliced access to a fixed-record WTF file."""

    def __init__(self, client: WtfClient, path: str, record_bytes: int):
        self.client = client
        self.path = path
        self.record_bytes = record_bytes
        self._f = client.open_file(path, "r")
        size = client.stat(path)["size"]
        if size % record_bytes:
            raise ValueError(
                f"{path}: size {size} is not a multiple of record size "
                f"{record_bytes}")
        self.count = size // record_bytes

    @property
    def handle(self):
        """The underlying ``WtfFile`` for direct vectored access."""
        return self._f

    # -- data-plane reads ---------------------------------------------------
    def read_record(self, idx: int) -> bytes:
        self._check(idx)
        return self._f.pread(self.record_bytes, idx * self.record_bytes)

    def read_records(self, start: int, n: int) -> bytes:
        self._check(start)
        n = min(n, self.count - start)
        return self._f.pread(n * self.record_bytes,
                             start * self.record_bytes)

    def read_records_batch(self, indices: Sequence[int]) -> List[bytes]:
        """Fetch many (possibly scattered) records in one vectored read —
        one transaction, coalesced slice fetches."""
        rb = self.record_bytes
        for i in indices:
            self._check(i)
        return self._f.readv([(i * rb, rb) for i in indices])

    def read_record_runs(self, runs: Sequence[Tuple[int, int]]
                         ) -> List[bytes]:
        """Vectored read of ``(start, n)`` record runs; one buffer per run."""
        return self._f.readv(self._ranges_of(runs))

    def read_record_runs_async(self, runs: Sequence[Tuple[int, int]]):
        """``read_record_runs`` through the async runtime: returns an
        ``IoFuture`` of the buffer list.  The caller can issue the next
        window's fetch before consuming this one — the overlap the data
        pipeline's prefetcher is built on."""
        return self._f.readv_async(self._ranges_of(runs))

    def _ranges_of(self, runs: Sequence[Tuple[int, int]]
                   ) -> List[Tuple[int, int]]:
        """Bounds-checked, EOF-clamped byte ranges for record runs — the
        one conversion shared by the vectored read and yank paths."""
        rb = self.record_bytes
        ranges = []
        for start, n in runs:
            self._check(start)
            n = min(n, self.count - start)
            ranges.append((start * rb, n * rb))
        return ranges

    def read_tokens(self, idx: int, dtype=np.int32) -> np.ndarray:
        return np.frombuffer(self.read_record(idx), dtype=dtype)

    # -- metadata-plane (zero-copy) ------------------------------------------
    def yank_records(self, start: int, n: int) -> List[Extent]:
        """Slice pointers for records [start, start+n) — no data I/O."""
        self._check(start)
        n = min(n, self.count - start)
        rb = self.record_bytes
        return list(self._f.yankv([(start * rb, n * rb)])[0])

    def yank_record_runs(self, runs: Sequence[Tuple[int, int]]
                         ) -> List[Tuple[Extent, ...]]:
        """Slice-pointer plans for many ``(start, n)`` record runs, computed
        in ONE transaction (one consistent snapshot of the file) — the
        batched flavor of ``yank_records`` used by shuffle/sort."""
        return self._f.yankv(self._ranges_of(runs))

    def _check(self, idx: int) -> None:
        if not (0 <= idx < self.count):
            raise IndexError(f"record {idx} out of range [0,{self.count})")

    def close(self) -> None:
        self._f.close()


def write_token_shard(client: WtfClient, path: str,
                      token_stream: Iterable[int], block_tokens: int,
                      dtype=np.int32) -> RecordSpec:
    """Pack a token stream into fixed ``block_tokens`` records; the tail
    partial block is dropped (standard LM-shard convention)."""
    itemsize = np.dtype(dtype).itemsize
    w = RecordWriter(client, path, block_tokens * itemsize)
    buf: list[int] = []
    for tok in token_stream:
        buf.append(tok)
        if len(buf) == block_tokens:
            w.append_array(np.asarray(buf, dtype=dtype))
            buf.clear()
    return w.close()
