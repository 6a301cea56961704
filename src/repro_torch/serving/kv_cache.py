"""Paged KV cache — WTF's slice indirection applied to attention state.

The port's own copy of the JAX package's numpy-only cache manager.

The mapping is exact:

  WTF slice            ≙  an immutable, full KV page
  WTF slice pointer    ≙  a page id in the page table
  metadata list        ≙  a sequence's page table row
  ``copy``/``concat``  ≙  prefix sharing between requests (refcounted, zero
                          data movement)
  tier-3 GC            ≙  refcount reclamation to the free list

Pages are immutable once full; the *open* (last, partially filled) page is
private to its sequence and is copy-on-write when a fork happens mid-page.
The ``paged_attention`` kernel consumes (pages, page_table, lengths)
directly — the indirection never gets materialized.

With ``allocate=True`` the pool is a host-side numpy structure; the serving
engine passes ``allocate=False`` and keeps the pools on the device.  All
bookkeeping is O(pages touched).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


class OutOfPages(RuntimeError):
    pass


@dataclass
class CacheConfig:
    num_layers: int
    num_kv_heads: int
    head_dim: int
    page_tokens: int = 16          # tokens per page
    num_pages: int = 1024          # pool size (per layer pair K/V)
    max_seqs: int = 64
    dtype: str = "float32"


class PagedKVCache:
    def __init__(self, cfg: CacheConfig, allocate: bool = True):
        self.cfg = cfg
        shape = (cfg.num_layers, cfg.num_pages, cfg.page_tokens,
                 cfg.num_kv_heads, cfg.head_dim)
        # allocate=False → metadata-only mode: an engine owns the pools
        # (device arrays) and uses this object purely as the page-table /
        # refcount manager (the WTF metadata layer)
        self.k_pages = np.zeros(shape if allocate else (0,),
                                dtype=cfg.dtype)
        self.v_pages = np.zeros(shape if allocate else (0,),
                                dtype=cfg.dtype)
        self.refcount = np.zeros(cfg.num_pages, dtype=np.int32)
        self._free: List[int] = list(range(cfg.num_pages - 1, -1, -1))
        # per-sequence state
        self.page_table: Dict[int, List[int]] = {}
        self.seq_len: Dict[int, int] = {}
        self.stats = {"pages_allocated": 0, "pages_shared": 0,
                      "pages_copied": 0, "pages_freed": 0}

    # ------------------------------------------------------------ plumbing
    def _alloc_page(self) -> int:
        if not self._free:
            raise OutOfPages("KV page pool exhausted")
        pid = self._free.pop()
        self.refcount[pid] = 1
        self.stats["pages_allocated"] += 1
        return pid

    def _release_page(self, pid: int) -> None:
        self.refcount[pid] -= 1
        if self.refcount[pid] == 0:
            self._free.append(pid)
            self.stats["pages_freed"] += 1

    def free_pages(self) -> int:
        return len(self._free)

    def in_use(self) -> int:
        """Pages held by some sequence (or reserved by the engine)."""
        return self.stats["pages_allocated"] - self.stats["pages_freed"]

    # ------------------------------------------------------------- seq API
    def create(self, seq_id: int) -> None:
        if seq_id in self.page_table:
            raise ValueError(f"sequence {seq_id} already exists")
        self.page_table[seq_id] = []
        self.seq_len[seq_id] = 0

    def release(self, seq_id: int) -> None:
        for pid in self.page_table.pop(seq_id):
            self._release_page(pid)
        del self.seq_len[seq_id]

    def append(self, seq_id: int, k: np.ndarray, v: np.ndarray) -> None:
        """Append ``t`` tokens of K/V: k,v shape
        [num_layers, t, num_kv_heads, head_dim]."""
        cfg = self.cfg
        t = k.shape[1]
        pos = self.seq_len[seq_id]
        table = self.page_table[seq_id]
        done = 0
        while done < t:
            page_slot = pos % cfg.page_tokens
            if page_slot == 0:
                table.append(self._alloc_page())
            pid = table[-1]
            if self.refcount[pid] > 1:
                # shared open page → copy-on-write before mutating
                pid = self._cow(table, len(table) - 1)
            take = min(t - done, cfg.page_tokens - page_slot)
            self.k_pages[:, pid, page_slot:page_slot + take] = \
                k[:, done:done + take]
            self.v_pages[:, pid, page_slot:page_slot + take] = \
                v[:, done:done + take]
            pos += take
            done += take
        self.seq_len[seq_id] = pos

    def _cow(self, table: List[int], idx: int) -> int:
        old = table[idx]
        new = self._alloc_page()
        self.k_pages[:, new] = self.k_pages[:, old]
        self.v_pages[:, new] = self.v_pages[:, old]
        self._release_page(old)
        table[idx] = new
        self.stats["pages_copied"] += 1
        return new

    def fork(self, parent: int, child: int) -> None:
        """Prefix sharing: the child references the parent's pages (WTF
        ``copy`` — metadata only).  Full pages are shared by refcount; the
        open page will be copy-on-written by whichever sequence appends."""
        if child in self.page_table:
            raise ValueError(f"sequence {child} already exists")
        table = list(self.page_table[parent])
        for pid in table:
            self.refcount[pid] += 1
        self.page_table[child] = table
        self.seq_len[child] = self.seq_len[parent]
        self.stats["pages_shared"] += len(table)

    # ------------------------------------------------------------ reads
    def gather(self, seq_id: int, layer: int) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize a sequence's K/V for one layer (reference path; the
        kernel reads pages in place instead)."""
        cfg = self.cfg
        n = self.seq_len[seq_id]
        table = self.page_table[seq_id]
        k = np.zeros((n, cfg.num_kv_heads, cfg.head_dim), dtype=cfg.dtype)
        v = np.zeros_like(k)
        for i in range(0, n, cfg.page_tokens):
            pid = table[i // cfg.page_tokens]
            take = min(cfg.page_tokens, n - i)
            k[i:i + take] = self.k_pages[layer, pid, :take]
            v[i:i + take] = self.v_pages[layer, pid, :take]
        return k, v

    def table_array(self, seq_ids: List[int],
                    max_pages: Optional[int] = None) -> Tuple[np.ndarray,
                                                              np.ndarray]:
        """(page_table, lengths) arrays for a decode batch — the kernel's
        input format.  Unused entries are -1."""
        if max_pages is None:
            max_pages = max((len(self.page_table[s]) for s in seq_ids),
                            default=1)
        tbl = np.full((len(seq_ids), max_pages), -1, dtype=np.int32)
        lens = np.zeros(len(seq_ids), dtype=np.int32)
        for i, s in enumerate(seq_ids):
            row = self.page_table[s]
            tbl[i, :len(row)] = row
            lens[i] = self.seq_len[s]
        return tbl, lens
