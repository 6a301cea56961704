"""Deterministic, resumable, multi-host training-data pipeline on WTF.

Per epoch, the pipeline materializes a *shuffled epoch file* with the
zero-copy shuffle (metadata only), then serves per-host batches by reading
contiguous record ranges.  Because every epoch file is a pure function of
(sources, seed, epoch), and the cursor is a single integer, the iterator
state is tiny and is checkpointed transactionally together with the model —
after a restart, data position and weights can never disagree.

Multi-host / elastic: hosts slice the batch by ``host_id``/``num_hosts``;
``with_hosts`` re-derives a pipeline for a new topology at the same global
step (elastic re-scale), which is valid precisely because epoch files are
deterministic and host assignment is stateless.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import WtfClient
from .records import RecordFile
from .shuffle import shuffle_epoch


@dataclass
class PipelineConfig:
    src_paths: Tuple[str, ...]
    work_dir: str                  # where epoch files live, e.g. /data/epochs
    block_tokens: int              # tokens per record (seq_len + 1)
    global_batch: int              # sequences per step across all hosts
    seed: int = 0
    dtype: str = "int32"
    run_length: int = 1            # shuffle granularity (records)
    host_id: int = 0
    num_hosts: int = 1
    prefetch: int = 2              # prefetched batches (0 = synchronous)
    # Issue each prefetch window's storage fetch through the async I/O
    # runtime (readv_async) so window W+1 is in flight while window W is
    # being consumed.  False reverts to one synchronous vectored read per
    # window (plan+fetch serialized with consumption) — the comparison the
    # pipeline_bench overlap scenario measures.
    async_prefetch: bool = True

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError("global_batch must divide evenly across hosts")


@dataclass
class PipelineState:
    """The checkpointable cursor — deliberately tiny."""
    epoch: int = 0
    step_in_epoch: int = 0

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "step_in_epoch": self.step_in_epoch}

    @staticmethod
    def from_dict(d: dict) -> "PipelineState":
        return PipelineState(d["epoch"], d["step_in_epoch"])


class DataPipeline:
    def __init__(self, client: WtfClient, config: PipelineConfig,
                 state: Optional[PipelineState] = None):
        self.client = client
        self.cfg = config
        self.state = state or PipelineState()
        self._itemsize = np.dtype(config.dtype).itemsize
        self.record_bytes = config.block_tokens * self._itemsize
        self._epoch_file: Optional[RecordFile] = None
        self._epoch_loaded = -1
        if not client.exists(config.work_dir):
            client.mkdir(config.work_dir)

    # ----------------------------------------------------------- epoch mgmt
    def _epoch_path(self, epoch: int) -> str:
        return f"{self.cfg.work_dir}/epoch-{epoch:05d}"

    def _ensure_epoch(self, epoch: int) -> RecordFile:
        if self._epoch_loaded == epoch and self._epoch_file is not None:
            return self._epoch_file
        path = self._epoch_path(epoch)
        if not self.client.exists(path):
            # Zero-copy shuffle: pure metadata, deterministic in (seed, epoch)
            shuffle_epoch(self.client, self.cfg.src_paths, path,
                          self.record_bytes,
                          seed=self.cfg.seed + epoch,
                          run_length=self.cfg.run_length)
        if self._epoch_file is not None:
            self._epoch_file.close()
        self._epoch_file = RecordFile(self.client, path, self.record_bytes)
        self._epoch_loaded = epoch
        return self._epoch_file

    @property
    def steps_per_epoch(self) -> int:
        f = self._ensure_epoch(self.state.epoch)
        return f.count // self.cfg.global_batch

    # ------------------------------------------------------------- batching
    def _host_batch(self, epoch: int, step: int) -> np.ndarray:
        """This host's rows of global step ``step`` in ``epoch``."""
        return self._host_batches(epoch, [step])[0]

    def _host_batches(self, epoch: int,
                      steps: Sequence[int]) -> list[np.ndarray]:
        """This host's rows for several global steps, fetched as ONE
        vectored read — the record runs of all steps are planned in a
        single transaction and their slice fetches batched per server."""
        f = self._ensure_epoch(epoch)
        raws = f.read_record_runs(self._window_runs(steps))
        return [self._blocks_of(raw) for raw in raws]

    def __iter__(self) -> Iterator[dict]:
        if self.cfg.prefetch > 0:
            return self._prefetching_iter()
        return self._sync_iter()

    def _sync_iter(self) -> Iterator[dict]:
        while True:
            epoch, step = self.state.epoch, self.state.step_in_epoch
            f = self._ensure_epoch(epoch)
            if (step + 1) * self.cfg.global_batch > f.count:
                self.state = PipelineState(epoch + 1, 0)
                continue
            blocks = self._host_batch(epoch, step)
            self.state = PipelineState(epoch, step + 1)
            yield {
                "tokens": blocks[:, :-1],
                "labels": blocks[:, 1:],
                "epoch": epoch,
                "step_in_epoch": step,
            }

    def _window_runs(self, steps: Sequence[int]) -> list[Tuple[int, int]]:
        per_host = self.cfg.global_batch // self.cfg.num_hosts
        return [(s * self.cfg.global_batch + self.cfg.host_id * per_host,
                 per_host) for s in steps]

    def _blocks_of(self, raw: bytes) -> np.ndarray:
        per_host = self.cfg.global_batch // self.cfg.num_hosts
        return np.frombuffer(raw, dtype=self.cfg.dtype).reshape(
            per_host, self.cfg.block_tokens)

    def _prefetching_iter(self) -> Iterator[dict]:
        """Background-thread prefetch on the async I/O runtime.

        The producer pulls up to ``prefetch`` steps per vectored read, so
        a prefetch window costs one storage round per server instead of
        one per step — and with ``async_prefetch`` it issues window W+1's
        fetch (``readv_async``) *before* awaiting window W's, so the
        metadata planning and data rounds of the next window overlap the
        consumption of the current one.  The trainer's step time then
        hides the pipeline's I/O twice over: behind the queue, and behind
        the in-flight future."""
        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.cfg.prefetch))
        stop = threading.Event()
        window = max(1, self.cfg.prefetch)

        def next_window(epoch: int, step: int):
            """Advance to the next non-empty window, crossing (and, on
            first touch, materializing) epoch boundaries.  Re-checks
            ``stop`` on every epoch bump — a shard smaller than one
            global batch has zero steps per epoch, and this loop must
            stay interruptible rather than materialize epoch files
            forever.  Returns ``None`` when stopping."""
            while not stop.is_set():
                f = self._ensure_epoch(epoch)
                spe = f.count // self.cfg.global_batch
                if step >= spe:
                    epoch, step = epoch + 1, 0
                    continue
                return epoch, list(range(step, min(step + window, spe))), f
            return None

        def emit(epoch: int, steps, raws) -> bool:
            for s, raw in zip(steps, raws):
                if stop.is_set():
                    return False
                blocks = self._blocks_of(raw)
                self.state = PipelineState(epoch, s + 1)
                q.put({
                    "tokens": blocks[:, :-1],
                    "labels": blocks[:, 1:],
                    "epoch": epoch,
                    "step_in_epoch": s,
                })
            return True

        def producer():
            pending = []                     # every issued, un-awaited future

            def issue(win):
                fu = win[2].read_record_runs_async(self._window_runs(win[1]))
                pending.append(fu)
                return fu

            def collect(fu):
                try:
                    return fu.result()
                finally:
                    pending.remove(fu)

            try:
                cur = next_window(self.state.epoch,
                                  self.state.step_in_epoch)
                if cur is None:
                    return
                fut = issue(cur) if self.cfg.async_prefetch else None
                while not stop.is_set():
                    epoch, steps, f = cur
                    if self.cfg.async_prefetch:
                        # Issue-ahead: the next window's fetch enters the
                        # runtime before this window's future is awaited.
                        # (The async read captured its inode at submission,
                        # so crossing an epoch — which closes the current
                        # RecordFile handle — cannot invalidate it.)
                        nxt = next_window(epoch, steps[-1] + 1)
                        if nxt is None:
                            return
                        nfut = issue(nxt)
                        raws, fut = collect(fut), nfut
                    else:
                        raws = f.read_record_runs(self._window_runs(steps))
                        nxt = None
                    if not emit(epoch, steps, raws):
                        return
                    cur = nxt if nxt is not None \
                        else next_window(epoch, steps[-1] + 1)
                    if cur is None:
                        return
            except Exception as e:           # surface errors to the consumer
                q.put(e)
            finally:
                for fu in list(pending):     # quiesce: no orphaned rounds,
                    try:                     # even when the awaited window
                        fu.result()          # failed with nfut in flight
                    except Exception:        # noqa: BLE001 - already stopping
                        pass

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # Deterministic shutdown for abandoned iterators: wake a
            # producer blocked on a full queue, then join it so no stray
            # fetch lands after the consumer is gone.
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=10)
            if t.is_alive():
                # A wedged producer (e.g. a fetch stuck on a dead server)
                # can still mutate state/stats after this point — make
                # that visible instead of silently pretending quiescence.
                import warnings
                warnings.warn(
                    "DataPipeline producer did not stop within 10s of "
                    "iterator shutdown; counters may keep moving",
                    RuntimeWarning, stacklevel=2)

    # ---------------------------------------------------------- elasticity
    def with_hosts(self, host_id: int, num_hosts: int) -> "DataPipeline":
        """Same logical stream, new topology (elastic re-scale)."""
        import dataclasses

        cfg = dataclasses.replace(self.cfg, host_id=host_id,
                                  num_hosts=num_hosts)
        return DataPipeline(self.client, cfg, state=self.state)
