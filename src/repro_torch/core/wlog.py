"""Kafka-style multi-producer durable log over ONE WTF file (§2.5 applied).

The workload the unserialized append path unlocks: many producers append
records to a single log file concurrently — each append is the paper's
commutative bounded *relative append*, so producers never conflict — while
consumers tail the committed prefix through the metadata plane's bounded-WAL
``subscribe`` stream, with no polling of file length and no busy reads.

Layout: the log file is a sequence of length-prefixed frames::

    [4-byte LE payload length][payload] [4-byte LE payload length][payload] …

One ``produce`` batch is flushed as ONE append (one transaction), so a frame
— and a whole batch of frames — becomes visible atomically: committed EOF
always lands on a frame boundary, and a reader of the committed prefix can
never observe a torn record.

Delivery pipeline (per consumer)::

    producer commit → WarpKV/ShardedKV WAL → subscribe fan-in (per-shard
    seq) → watermark advance (listener) → pread of [consumed, watermark) →
    frame reassembly → poll() returns payloads

The subscribe listener runs under the committing shard's locks, so it does
the absolute minimum: fold region events for the log's inode into a
monotone *committed-bytes watermark* (``region_index * region_size +
region.end``) and record the per-shard sequence high-water mark.  All real
work — the transactional ``pread`` and frame parsing — happens on the
consumer's own thread in ``poll``.  Because the per-shard sequence numbers
are gap-free, ``shard_seqs`` is a complete account of how much of each
shard's stream the consumer has folded in.

Replay contract: **at-least-once**.  ``LogConsumer.position`` is the
frame-aligned absolute offset just past the last fully-delivered record; a
consumer restarted with ``consumer(from_offset=saved_position)`` re-reads
nothing, while a restart from an older checkpoint re-delivers the suffix
(duplicates possible, loss impossible — the bytes are durable and the
watermark is rebuilt from the WAL snapshot replay, so no delivery depends
on the lost consumer's state).

Producers and consumers each own a private ``WtfClient`` and are
thread-confined (one producer/consumer per thread, any number of threads).

Determinism guarantee the benchmarks assert: consumers of the same log
deliver byte-identical streams (same payloads, same order — file order),
regardless of shard count or lease configuration; across *runs* the
interleaving of producers differs, so cross-run comparison uses the
order-independent ``content_digest`` plus per-producer FIFO, which together
pin exactly what the log promises.
"""
from __future__ import annotations

import hashlib
import struct
import threading
import time
from typing import Iterable, List, Optional

from .client_runtime import normalize_path
from .errors import WtfError
from .testing import witness_lock

_LEN = struct.Struct("<I")
FRAME_HEADER = _LEN.size


def frame(payload: bytes) -> bytes:
    """One length-prefixed log frame."""
    return _LEN.pack(len(payload)) + payload


def content_digest(payloads: Iterable[bytes]) -> str:
    """Order-independent digest of a record multiset.

    Concurrent producers interleave differently run to run, so two runs of
    the same workload agree on the record *multiset*, not the file order.
    Summing per-record hashes is commutative and multiset-exact (a dropped,
    duplicated, or corrupted record changes the sum), which is precisely
    the cross-run/cross-config delivery check.
    """
    acc = 0
    for p in payloads:
        acc = (acc + int.from_bytes(
            hashlib.blake2b(p, digest_size=16).digest(), "little")) % (1 << 128)
    return f"{acc:032x}"


class WtfLog:
    """Handle for one durable log file; mints producers and consumers."""

    def __init__(self, cluster, path: str, create: bool = True):
        self.cluster = cluster
        self.path = path
        boot = cluster.client()
        if create and cluster.kv.get("paths", normalize_path(path)) is None:
            fd = boot.open(path, "w")
            boot.close(fd)
        ino_id = cluster.kv.get("paths", normalize_path(path))
        if ino_id is None:
            raise WtfError(f"no such log file: {path}")
        ino = cluster.kv.get("inodes", ino_id)
        self.inode_id = ino_id
        self.region_size = ino.region_size

    def producer(self, batch_records: int = 1,
                 write_behind: bool = False) -> "LogProducer":
        return LogProducer(self, batch_records=batch_records,
                           write_behind=write_behind)

    def consumer(self, from_offset: int = 0) -> "LogConsumer":
        return LogConsumer(self, from_offset=from_offset)


class LogProducer:
    """One appending producer (thread-confined).

    ``produce`` frames the payload into a local batch; every
    ``batch_records`` records the batch is flushed as ONE append — one
    transaction, one commit — so batching divides the per-record commit
    cost.  ``write_behind=True`` routes the append through a buffered
    handle: the payload store defers into the client's write-behind buffer
    and lands via the batched store scheduler at the commit flush.
    """

    def __init__(self, log: WtfLog, batch_records: int = 1,
                 write_behind: bool = False):
        if batch_records < 1:
            raise ValueError(
                f"batch_records must be >= 1, got {batch_records}")
        self.log = log
        self.batch_records = batch_records
        self._client = log.cluster.client()
        self._handle = self._client.open_file(log.path, "a",
                                              buffered=write_behind)
        self._batch: List[bytes] = []
        self.produced_records = 0
        self.produced_bytes = 0
        self.flushes = 0

    def produce(self, payload: bytes) -> None:
        self._batch.append(frame(payload))
        self.produced_records += 1
        self.produced_bytes += len(payload)
        if len(self._batch) >= self.batch_records:
            self.flush()

    def flush(self) -> None:
        if not self._batch:
            return
        blob = b"".join(self._batch)
        self._batch.clear()
        n = self._handle.write(blob)
        if n != len(blob):
            raise WtfError(f"short log append: {n} != {len(blob)}")
        self.flushes += 1

    def close(self) -> None:
        self.flush()
        self._handle.close()


class LogConsumer:
    """One tailing consumer (thread-confined).

    Wakes on committed appends via the WAL subscribe stream, reads the
    newly-committed byte range transactionally, and returns whole records.
    ``digest`` is a running hash over delivered payloads in delivery
    order — byte-identical across every consumer of the same log.
    """

    def __init__(self, log: WtfLog, from_offset: int = 0):
        if from_offset < 0:
            raise ValueError(f"from_offset must be >= 0, got {from_offset}")
        self.log = log
        self._client = log.cluster.client()
        self._fd = self._client.open(log.path, "r")
        self._cond = threading.Condition(
            witness_lock(threading.Lock(), "wlog.consumer"))
        self._committed = 0           # monotone committed-bytes watermark
        self._read_pos = from_offset  # bytes handed to the reassembler
        self._closed = False
        self._buf = bytearray()
        self._parse_off = 0
        self.position = from_offset   # frame-aligned at-least-once cursor
        self.records = 0
        self.shard_seqs: dict[int, int] = {}
        self._digest = hashlib.blake2b(digest_size=16)
        # Subscribe LAST: replay (under the WAL lock, atomic with listener
        # registration) folds every already-committed region of this inode
        # into the watermark, so a late consumer starts complete.
        self._cancel = log.cluster.kv.subscribe(self._on_wal, with_meta=True)

    # -- WAL listener: runs under the committing shard's locks; minimal ----
    def _on_wal(self, space, key, value, version, shard, seq) -> None:
        with self._cond:
            self.shard_seqs[shard] = seq
            if (space == "regions" and isinstance(key, tuple)
                    and key[0] == self.log.inode_id and value is not None):
                end = key[1] * self.log.region_size + value.end
                if end > self._committed:
                    self._committed = end
                    self._cond.notify_all()

    # -- pull side ---------------------------------------------------------
    def poll(self, timeout: Optional[float] = 1.0,
             max_bytes: Optional[int] = None) -> List[bytes]:
        """Return the next batch of complete records, blocking up to
        ``timeout`` seconds for new committed bytes (``[]`` on timeout or
        after ``close``)."""
        with self._cond:
            if timeout is not None:
                deadline = time.monotonic() + timeout
            while self._committed <= self._read_pos and not self._closed:
                if timeout is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(remaining):
                        return []
            if self._closed:
                return []
            hi = self._committed
        if max_bytes is not None:
            hi = min(hi, self._read_pos + max_bytes)
        if hi <= self._read_pos:
            return []
        data = self._client.pread(self._fd, hi - self._read_pos,
                                  self._read_pos)
        # wtf-lint: ignore[WTF003] -- poll() is consumer-thread-confined by contract; _cond only publishes the commit watermark
        self._buf += data
        self._read_pos += len(data)  # wtf-lint: ignore[WTF003] -- consumer-thread-confined (see above)
        out: List[bytes] = []
        while True:
            avail = len(self._buf) - self._parse_off
            if avail < FRAME_HEADER:
                break
            (ln,) = _LEN.unpack_from(self._buf, self._parse_off)
            if avail < FRAME_HEADER + ln:
                break                 # partial frame: wait for more bytes
            start = self._parse_off + FRAME_HEADER
            payload = bytes(self._buf[start:start + ln])
            self._parse_off = start + ln
            self._digest.update(payload)
            self.records += 1  # wtf-lint: ignore[WTF003] -- consumer-thread-confined (see poll above)
            out.append(payload)
        if self._parse_off:
            self.position += self._parse_off  # wtf-lint: ignore[WTF003] -- consumer-thread-confined (see poll above)
            del self._buf[:self._parse_off]
            self._parse_off = 0
        return out

    @property
    def committed(self) -> int:
        """Current committed-bytes watermark (absolute file offset)."""
        with self._cond:
            return self._committed

    def digest(self) -> str:
        """Hash over delivered payloads in delivery order."""
        return self._digest.hexdigest()

    def close(self) -> None:
        self._cancel()
        with self._cond:
            self._closed = True
            self._cond.notify_all()
