"""Zero-copy global shuffle and dataset mixing (the paper's technique as a
training-data primitive).

A global shuffle of N fixed-size records is a permutation of their slice
pointers: yank every record, permute, paste into the epoch file.  Data bytes
moved: **zero** — the same property that gives the paper's sort benchmark its
4× win (§4.1, Table 2).  The shuffled file then reads *sequentially* for the
trainer, and locality-aware placement keeps those reads contiguous per
source region.

Vectored execution: all runs of a source shard are yanked with ONE
``yankv`` per shard and the permuted pointer order is pasted with ONE
``pastev`` — the op log holds a handful of vectored ops instead of one op
per record, so both the commit and any §2.6 replay stay O(shards), not
O(records).

Mixing datasets with weights is the same trick: interleave yanked record
runs from each source proportionally to the weights.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import WtfClient
from .records import RecordFile, RecordSpec


def shuffle_epoch(client: WtfClient, src_paths: Sequence[str],
                  dst_path: str, record_bytes: int, seed: int,
                  run_length: int = 1) -> int:
    """Create ``dst_path`` = a seeded permutation of all records across the
    source shards.  Returns the number of records.

    ``run_length`` shuffles *runs* of consecutive records instead of single
    records — coarser shuffling that preserves more disk locality (longer
    mergeable extents), the classic shuffle-quality/IO-locality dial.
    """
    files = [RecordFile(client, p, record_bytes) for p in src_paths]
    runs: List[Tuple[int, int, int]] = []      # (file idx, start, n)
    per_file_runs: List[List[Tuple[int, int]]] = [[] for _ in files]
    run_slot: List[Tuple[int, int]] = []       # run idx -> (file, slot)
    for fi, f in enumerate(files):
        for start in range(0, f.count, run_length):
            n = min(run_length, f.count - start)
            runs.append((fi, start, n))
            run_slot.append((fi, len(per_file_runs[fi])))
            per_file_runs[fi].append((start, n))

    rng = np.random.Generator(np.random.Philox(seed))
    order = rng.permutation(len(runs))

    total = sum(n for _, _, n in runs)
    with client.transaction():
        # One yankv per shard: every run's slice pointers in one op.
        yanked = [f.yank_record_runs(per_file_runs[fi])
                  for fi, f in enumerate(files)]
        # One pastev: the entire permuted epoch in a single atomic op.
        batches = []
        for ri in order:
            fi, slot = run_slot[ri]
            batches.append(yanked[fi][slot])
        with client.open_file(dst_path, "w") as dst:
            dst.pastev(batches)
    for f in files:
        f.close()
    return total


def mix_datasets(client: WtfClient, specs: Sequence[Tuple[str, float]],
                 dst_path: str, record_bytes: int, seed: int,
                 total_records: Optional[int] = None) -> int:
    """Weighted mixture: dst is an interleaving of source records where
    source i contributes proportionally to its weight.  Zero data I/O.

    Sampling is without replacement per source; a source that runs dry stops
    contributing (the remaining weights renormalize implicitly).  Record
    pointers are pre-yanked per source with one vectored op and the chosen
    interleaving is pasted with one ``pastev``.
    """
    files = [RecordFile(client, p, record_bytes) for p, _ in specs]
    weights = np.asarray([w for _, w in specs], dtype=np.float64)
    weights = weights / weights.sum()
    rng = np.random.Generator(np.random.Philox(seed))
    cursors = [0] * len(files)
    budget = (sum(f.count for f in files)
              if total_records is None else total_records)

    # Decide the interleaving first (pure RNG, no I/O), then yank exactly
    # the chosen records — O(budget), never O(total records in sources).
    picks: List[Tuple[int, int]] = []          # (source idx, record idx)
    written = 0
    while written < budget:
        avail = [i for i, f in enumerate(files) if cursors[i] < f.count]
        if not avail:
            break
        w = weights[avail]
        src = int(rng.choice(avail, p=w / w.sum()))
        picks.append((src, cursors[src]))
        cursors[src] += 1
        written += 1

    with client.transaction():
        per_src: dict[int, List[int]] = {}
        for src, idx in picks:
            per_src.setdefault(src, []).append(idx)
        yanked = {
            src: dict(zip(idxs, files[src].yank_record_runs(
                [(i, 1) for i in idxs])))
            for src, idxs in per_src.items()
        }
        with client.open_file(dst_path, "w") as dst:
            dst.pastev([yanked[src][idx] for src, idx in picks])
    for f in files:
        f.close()
    return written
