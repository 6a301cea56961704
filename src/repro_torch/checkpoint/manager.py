"""Transactional distributed checkpointing on WTF.

Why a transactional filesystem is the right substrate for checkpoints at
scale:

* **Atomic multi-host commit.** Each host writes its shard files; the final
  ``commit`` transaction writes the manifest and flips ``latest`` in one
  atomic action.  A reader (restarting job, evaluator) either sees a
  complete checkpoint or the previous one — never a torn one.  Slices are
  durable *before* the metadata commit (§2.1), so the commit is pure
  metadata regardless of checkpoint size.
* **Incremental checkpoints for free.** Unchanged leaves (content digest
  match vs. the previous step) are ``copy``'d — slice sharing, zero data
  I/O (frozen embeddings, optimizer ints, EMA shadows...).
* **Zero-copy resharding.** Changing the device topology (elastic scaling)
  re-partitions each leaf's flat byte range with ``yank``/``paste``
  arithmetic — no data rewrite of multi-TB checkpoints.
* **Retention = unlink.** Dropped checkpoints become storage-server garbage
  that the paper's tier-3 GC reclaims sparsely.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import NotFound, WtfClient
from .serialize import (bytes_to_leaf, decode_manifest, encode_manifest,
                        flatten_tree, leaf_to_bytes, unflatten_tree)


class CheckpointManager:
    def __init__(self, client: WtfClient, root: str = "/ckpt",
                 keep: Optional[int] = None):
        self.client = client
        self.root = root
        self.keep = keep
        if not client.exists(root):
            client.mkdir(root)

    # ------------------------------------------------------------- paths
    def _step_dir(self, step: int) -> str:
        return f"{self.root}/step-{step:010d}"

    def _leaf_path(self, step: int, name: str, shard: int,
                   num_shards: int) -> str:
        safe = name.replace("/", ".")
        return f"{self._step_dir(step)}/{safe}.{shard:04d}-of-{num_shards:04d}"

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree: Any, *, host_id: int = 0,
             num_hosts: int = 1, extra: Optional[dict] = None,
             prev_step: Optional[int] = None) -> dict:
        """Write this host's shards, then (host 0) atomically commit.

        Leaves are sharded across hosts on their leading axis when possible;
        small leaves are written by host 0 alone.  With ``prev_step`` given,
        unchanged leaves are shared with the previous checkpoint via
        ``copy`` instead of rewritten (incremental checkpointing).
        """
        flat = flatten_tree(tree)
        step_dir = self._step_dir(step)
        if not self.client.exists(step_dir):
            try:
                self.client.mkdir(step_dir)
            except Exception:
                pass                       # another host won the race

        prev_manifest = None
        if prev_step is not None:
            try:
                prev_manifest = self.read_manifest(prev_step)
            except NotFound:
                prev_manifest = None

        entries: Dict[str, dict] = {}
        stats = {"bytes_written": 0, "bytes_shared": 0, "leaves_shared": 0}
        # One transaction per host: the host's shard set publishes
        # atomically, and with write-behind every leaf's stores (plus, for
        # a single-host save, the manifest itself) flush through the write
        # scheduler in ONE planning pass at this commit.
        with self.client.transaction():
            for name, leaf in flat.items():
                data, meta = leaf_to_bytes(leaf)
                shards = self._shards_for(meta, num_hosts)
                meta["shards"] = shards
                entries[name] = meta
                prev = (prev_manifest or {}).get("leaves", {}).get(name)
                if (prev is not None and prev["digest"] == meta["digest"]
                        and prev["shards"] == shards):
                    # Incremental: identical content — share the old slices.
                    if host_id == 0:
                        for s in range(shards):
                            src = self._leaf_path(prev_step, name, s, shards)
                            dst = self._leaf_path(step, name, s, shards)
                            self.client.copy(src, dst)
                        stats["bytes_shared"] += meta["nbytes"]
                        stats["leaves_shared"] += 1
                    continue
                for s in range(shards):
                    if s % num_hosts != host_id:
                        continue           # not this host's shard
                    lo, hi = self._shard_range(meta["nbytes"], shards, s)
                    path = self._leaf_path(step, name, s, shards)
                    with self.client.open_file(path, "w") as f:
                        # writev: the shard's stores are planned as one
                        # batch and fanned out per region by the write
                        # scheduler (wsched) instead of a single
                        # synchronous store round.
                        f.writev([data[lo:hi]])
                    stats["bytes_written"] += hi - lo
            if host_id == 0 and num_hosts == 1:
                # Single-host save: shards + manifest + ``latest`` flip
                # commit (and flush) as one transaction.
                self._commit(step, entries, extra or {})

        if host_id == 0:
            if num_hosts > 1:
                self._commit(step, entries, extra or {})
            if self.keep is not None:
                self.retain(self.keep)
        return stats

    def _commit(self, step: int, entries: Dict[str, dict],
                extra: dict) -> None:
        """The atomic rendezvous: manifest + ``latest`` flip in one txn
        (joins the caller's open transaction when there is one)."""
        c = self.client
        if c._txn is not None:
            self._commit_ops(step, entries, extra)
            return
        with c.transaction():
            self._commit_ops(step, entries, extra)

    def _commit_ops(self, step: int, entries: Dict[str, dict],
                    extra: dict) -> None:
        c = self.client
        with c.open_file(f"{self._step_dir(step)}/manifest", "w") as f:
            f.write(encode_manifest(entries, {"step": step, **extra}))
        latest = f"{self.root}/latest"
        if c.exists(latest):
            c.unlink(latest)
        c.link(f"{self._step_dir(step)}/manifest", latest)

    @staticmethod
    def _shards_for(meta: dict, num_hosts: int) -> int:
        # shard big leaves across hosts; keep small ones whole
        if num_hosts > 1 and meta["nbytes"] >= 1 << 16:
            return num_hosts
        return 1

    @staticmethod
    def _shard_range(nbytes: int, shards: int, s: int) -> Tuple[int, int]:
        per = -(-nbytes // shards)
        return s * per, min(nbytes, (s + 1) * per)

    # -------------------------------------------------------------- restore
    def read_manifest(self, step: Optional[int] = None) -> dict:
        c = self.client
        path = (f"{self.root}/latest" if step is None
                else f"{self._step_dir(step)}/manifest")
        with c.open_file(path, "r") as f:
            raw = f.read()
        return decode_manifest(raw)

    def latest_step(self) -> Optional[int]:
        try:
            return self.read_manifest()["step"]
        except NotFound:
            return None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Rebuild the pytree (all leaves, any host).

        Every shard's fetch is issued through the async I/O runtime before
        the first byte is awaited, so shards fan out across servers and a
        restore completes in roughly one shard's latency per server rather
        than the sum of all shard reads.  Inside an open transaction
        (async ops are auto-commit only) the shards read synchronously,
        preserving the old join-the-caller's-transaction behavior."""
        man = self.read_manifest(step)
        step = man["step"]
        c = self.client
        in_txn = c._txn is not None
        handles, futs = [], []
        parts: Dict[str, List[bytes]] = {}
        try:
            for name, meta in man["leaves"].items():
                for s in range(meta["shards"]):
                    path = self._leaf_path(step, name, s, meta["shards"])
                    f = c.open_file(path, "r")
                    if in_txn:
                        parts.setdefault(name, []).append(f.read())
                        f.close()
                        continue
                    # Shard size comes from the manifest (no per-shard
                    # stat round at submission — the fan-out's win would
                    # otherwise be re-serialized by L×S stat calls).
                    lo, hi = self._shard_range(meta["nbytes"],
                                               meta["shards"], s)
                    handles.append(f)
                    futs.append((name, f.preadv_async([hi - lo], 0)))
            for name, fut in futs:
                parts.setdefault(name, []).append(fut.result()[0])
        finally:
            for f in handles:
                f.close()
        # Single-shard leaves keep the vectored read's zero-copy buffer
        # all the way into np.frombuffer; only multi-shard leaves join.
        flat = {name: bytes_to_leaf(ps[0] if len(ps) == 1 else b"".join(ps),
                                    man["leaves"][name])
                for name, ps in parts.items()}
        return unflatten_tree(flat, template)

    # ------------------------------------------------------------ reshard
    def reshard(self, step: int, new_shards: int, dst_step: int) -> None:
        """Re-partition every leaf for a new host count — zero data I/O.

        Each new shard file is a ``concat`` of yanked byte ranges of the old
        shard files; multi-TB checkpoints reshard in metadata time.
        """
        man = self.read_manifest(step)
        c = self.client
        if not c.exists(self._step_dir(dst_step)):
            c.mkdir(self._step_dir(dst_step))
        new_entries: Dict[str, dict] = {}
        for name, meta in man["leaves"].items():
            old_n = meta["shards"]
            n = new_shards if meta["nbytes"] >= 1 << 16 else 1
            with c.transaction():
                # yank each old shard fully (positional vectored yank —
                # no seek/stat dance), building the flat extent list
                flat_extents = []
                for s in range(old_n):
                    lo, hi = self._shard_range(meta["nbytes"], old_n, s)
                    path = self._leaf_path(step, name, s, old_n)
                    with c.open_file(path, "r") as f:
                        flat_extents.extend(f.yankv([(0, hi - lo)])[0])
                # paste computed byte ranges into the new shard files
                for s in range(n):
                    lo, hi = self._shard_range(meta["nbytes"], n, s)
                    path = self._leaf_path(dst_step, name, s, n)
                    with c.open_file(path, "w") as f:
                        f.paste(_carve(flat_extents, lo, hi - lo))
            new_entries[name] = {**meta, "shards": n}
        self._commit(dst_step, new_entries,
                     {"resharded_from": step, "step": dst_step})

    # ------------------------------------------------------------ retention
    def list_steps(self) -> List[int]:
        out = []
        for name in self.client.listdir(self.root):
            if name.startswith("step-"):
                out.append(int(name.split("-")[1]))
        return sorted(out)

    def retain(self, keep: int) -> List[int]:
        """Unlink all but the newest ``keep`` checkpoints; slices become
        tier-3 garbage reclaimed by the storage GC."""
        steps = self.list_steps()
        victims = steps[:-keep] if keep > 0 else []
        for step in victims:
            d = self._step_dir(step)
            for name in self.client.listdir(d):
                self.client.unlink(f"{d}/{name}")
            self.client.rmdir(d)
        return victims


def _carve(extents: Sequence[Any], start: int, length: int) -> list:
    """Sub-range [start, start+length) of a concatenated extent list."""
    out = []
    cursor = 0
    for e in extents:
        lo = max(start, cursor)
        hi = min(start + length, cursor + e.length)
        if lo < hi:
            out.append(e.sub(lo - cursor, hi - lo))
        cursor += e.length
        if cursor >= start + length:
            break
    return out


class AsyncCheckpointer:
    """Off-critical-path checkpointing on the unified I/O runtime: the
    whole shard save runs as one submitted op on the cluster's pool (no
    ad-hoc thread), and the trainer only blocks if a previous save is
    still in flight (one outstanding save, preserving step order).  A
    failed save re-raises on the next ``wait``/``save``.

    Saves run through a PRIVATE client bound to the same cluster: the
    save's transaction would otherwise set the shared client's ``_txn``
    from a pool worker, making every concurrent async op on that client
    (e.g. the data pipeline's prefetcher) spuriously reject itself —
    clients are one-per-thread by contract, and the worker is a thread.
    """

    def __init__(self, manager: CheckpointManager):
        self.manager = manager
        self._mgr = CheckpointManager(manager.client.cluster.client(),
                                      manager.root, keep=manager.keep)
        self._fut = None

    def save(self, step: int, tree: Any, **kw) -> None:
        self.wait()
        # Snapshot leaves NOW (cheap on host) so the trainer may mutate.
        snap = {k: np.array(v) for k, v in flatten_tree(tree).items()}
        runtime = self._mgr.client.cluster.runtime
        self._fut = runtime.submit_op(
            lambda: self._mgr.save(step, snap, **kw))

    def wait(self) -> None:
        if self._fut is not None:
            fut, self._fut = self._fut, None
            fut.result()                    # re-raises a failed save
