"""Continuous-batching serving engine over the paged KV cache (PyTorch).

WTF's design, end to end: the PagedKVCache (metadata manager) plays the
HyperDex role — page tables are metadata lists, pages are slices, prefix
forking is `copy` — while the device pools play the storage servers.  The
decode step hands the page table straight to the paged-attention kernel;
gathered K/V is never materialized.

Dense-family models (smollm / qwen2 / command-r / mistral-large / llava
text prompts).  Layout: pools [L, P, T, Hkv, D] on the device.  Prefill
writes a prompt's K/V into its pages, decode appends one token per step
for the whole batch.  Unlike the JAX engine, whose pools
are immutable and rebuilt on every write, this engine writes pages and
copy-on-write copies IN PLACE into its pools, and hands each layer's
[P, T, Hkv, D] view to the kernel with its strides: at qwen2-7b width a
pool is ~0.94 GB, and a copy per write or per layer would dominate.

On a CUDA device decode runs the CUDA paged-attention kernel and prefill
runs the attention that ``attn_impl`` selects ("pallas": the CUDA flash
kernel); on the CPU both take the kernels' plain versions.

While a ``torch.profiler`` session records, each admission and decode step
records its spans and counts (``repro_torch.trace``): ``engine.add`` (the
prompt's tokens, those of a fork's shared prefix, and those the prefill
ran through the forward) and ``engine.step`` (prepare, upload, forward,
sync, post; the pool's pages in use).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import trace
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import layers as L
from repro_torch.models.common import resolve_device, to_dtype, tree_map
from repro_torch.models.dense import layer
from .kv_cache import CacheConfig, PagedKVCache


@dataclass
class EngineConfig:
    page_tokens: int = 16
    num_pages: int = 2048
    device: str = "cuda"


@dataclass
class Request:
    seq_id: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(self, model, params, cfg: Optional[EngineConfig] = None):
        cfg = cfg or EngineConfig()
        mcfg = model.cfg
        if mcfg.arch_kind not in ("dense", "vlm"):
            raise ValueError("paged engine supports the dense family")
        self.model = model
        self.mcfg = mcfg
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        dt = to_dtype(mcfg.compute_dtype)
        # compute-dtype weights, cast once: the values of the JAX engine's
        # per-use casts (a no-op when param and compute dtypes agree)
        self.params = tree_map(lambda t: t.to(device=self.device, dtype=dt),
                               params)
        hd = mcfg.head_dim_
        self.cache = PagedKVCache(CacheConfig(
            num_layers=mcfg.n_layers, num_kv_heads=mcfg.n_kv_heads,
            head_dim=hd, page_tokens=cfg.page_tokens,
            num_pages=cfg.num_pages, dtype="float32"), allocate=False)
        shape = (mcfg.n_layers, cfg.num_pages, cfg.page_tokens,
                 mcfg.n_kv_heads, hd)
        self.k_pool = torch.zeros(shape, dtype=dt, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dt, device=self.device)
        # reserved scratch page: prefill writes of already-shared prefix
        # positions are redirected here so shared pages stay immutable
        self.scratch_page = self.cache._alloc_page()
        self._requests: Dict[int, Request] = {}
        self._next_id = 0

    # ------------------------------------------------------------ requests
    @torch.no_grad()
    def add(self, prompt: np.ndarray, max_new: int = 16,
            fork_from: Optional[int] = None) -> int:
        """Admit a request.  `fork_from` shares the parent's prefix pages
        (WTF `copy`: refcounted, zero data movement); positions of the
        shared prefix are recomputed but not written."""
        shared = 0
        if fork_from is not None:
            shared = self.cache.seq_len[fork_from]
            if len(prompt) < shared:
                raise ValueError(f"fork prefix ({shared} tokens) longer "
                                 f"than the prompt ({len(prompt)})")
        sid = self._next_id
        self._next_id += 1
        with trace.span("engine.add", rid=sid, prompt_tokens=len(prompt),
                        cached_tokens=shared, computed_tokens=0) as s:
            if fork_from is not None:
                self.cache.fork(fork_from, sid)
                if shared % self.cfg.page_tokens:
                    # shared prefix ends mid-page: COW the open page so the
                    # suffix prefill cannot touch the parent's copy
                    self._cow_page(sid, shared // self.cfg.page_tokens)
            else:
                self.cache.create(sid)
            req = Request(sid, prompt, max_new)
            if len(prompt) > shared:
                # the prefill's last-position logits ARE the first output token
                req.out.append(self._run_prefill(sid, prompt, shared, s))
                req.done = len(req.out) >= max_new
            self._requests[sid] = req
        return sid

    def _cow_page(self, sid: int, page_idx: int) -> None:
        """Give ``sid`` a private copy of a shared page, copied in place
        inside the pools."""
        tbl = self.cache.page_table[sid]
        pid = tbl[page_idx]
        if self.cache.refcount[pid] <= 1:
            return
        new = self.cache._alloc_page()
        self.k_pool[:, new] = self.k_pool[:, pid]
        self.v_pool[:, new] = self.v_pool[:, pid]
        self.cache._release_page(pid)
        tbl[page_idx] = new
        self.cache.stats["pages_copied"] += 1

    def _ensure_pages(self, sid: int, upto: int) -> None:
        t = self.cfg.page_tokens
        table = self.cache.page_table[sid]
        while len(table) * t < upto:
            table.append(self.cache._alloc_page())

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _run_prefill(self, sid: int, prompt: np.ndarray, start: int,
                     span=trace.OFF) -> int:
        n = len(prompt)
        self._ensure_pages(sid, n)
        table = np.asarray(self.cache.page_table[sid], np.int64)
        tokens = self._tensor(np.asarray(prompt, np.int64)[None, :])
        span["computed_tokens"] = tokens.shape[1]
        next_tok = _prefill_step(
            self.params, self.k_pool, self.v_pool, tokens,
            self._tensor(table[None, :]), start, self.scratch_page,
            cfg=self.mcfg, page_tokens=self.cfg.page_tokens)
        self.cache.seq_len[sid] = n
        return int(next_tok[0])

    # --------------------------------------------------------------- step
    @torch.no_grad()
    def step(self) -> List[int]:
        """One decode step for every active sequence; returns finished ids."""
        active = [r for r in self._requests.values() if not r.done]
        if not active:
            return []
        with trace.span("engine.step") as s:
            with trace.span("engine.step.prepare"):
                b = len(active)
                t = self.cfg.page_tokens
                tokens = np.zeros((b, 1), np.int64)
                pos = np.zeros((b,), np.int64)
                for i, r in enumerate(active):
                    tokens[i, 0] = r.out[-1]       # prefill seeded out[0]
                    pos[i] = self.cache.seq_len[r.seq_id]
                    self._ensure_pages(r.seq_id, int(pos[i]) + 1)
                    # COW before writing into a shared open page
                    self._cow_page(r.seq_id, int(pos[i]) // t)
                tbl_arr, _ = self.cache.table_array(
                    [r.seq_id for r in active])
            with trace.span("engine.step.upload"):
                inputs = (self._tensor(tokens), self._tensor(pos),
                          self._tensor(np.maximum(tbl_arr, 0)))
            with trace.span("engine.step.forward", device=True):
                next_tok = _decode_step(self.params, self.k_pool,
                                        self.v_pool, *inputs, cfg=self.mcfg,
                                        page_tokens=t)
            with trace.span("engine.step.sync"):
                next_tok = next_tok.cpu().numpy()
            with trace.span("engine.step.post"):
                finished = []
                for i, r in enumerate(active):
                    self.cache.seq_len[r.seq_id] += 1
                    r.out.append(int(next_tok[i]))
                    if len(r.out) >= r.max_new:
                        r.done = True
                        finished.append(r.seq_id)
            s["pages_in_use"] = self.cache.in_use()
            s["pool_pages"] = self.cfg.num_pages
        return finished

    def result(self, sid: int) -> List[int]:
        return self._requests[sid].out

    def release(self, sid: int) -> None:
        self.cache.release(sid)
        self._requests.pop(sid, None)


# ---------------------------------------------------------------- compute
def _scatter_pages(pool_l: torch.Tensor, vals: torch.Tensor,
                   pages: torch.Tensor, slots: torch.Tensor) -> None:
    """Write vals [B, S, Hkv, D] into pool_l [P, T, Hkv, D] at
    (pages, slots) [B, S], in place."""
    pool_l[pages, slots] = vals.to(pool_l.dtype)


def _block_rest(p, x, y, attn, cfg):
    """Output projection and MLP of a block whose normed input is y: a
    parallel block (command-r) sums both branches of y onto x, where the
    JAX engine runs such a config as a sequential one."""
    if cfg.parallel_block:
        return x + L.attn_out(p, attn, cfg) + L.swiglu(p, y, cfg,
                                                        pre_normed=True)
    x = x + L.attn_out(p, attn, cfg)
    return x + L.swiglu({**p, "ln": p["ln2"]}, x, cfg)


def _prefill_step(params, k_pool, v_pool, tokens, table, start: int,
                  scratch_page: int, *, cfg, page_tokens: int):
    """Full-prompt forward that writes the prompt's K/V into its pages in
    place and returns the greedy next token.  tokens/table: [1, S] /
    [1, PP].  Positions < `start` belong to a shared (immutable) prefix:
    their writes go to the reserved scratch page."""
    x = L.embed(params, tokens, cfg)
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    pages = torch.gather(table, 1, pos // page_tokens)
    pages = torch.where(pos < start, scratch_page, pages)
    slots = pos % page_tokens
    for li in range(cfg.n_layers):
        p = layer(params, li)
        y = L.rms_norm(x, p["ln"], cfg.norm_eps)
        q, k, v = L.qkv(p, y, cfg, pos)
        _scatter_pages(k_pool[li], k, pages, slots)
        _scatter_pages(v_pool[li], v, pages, slots)
        attn = L.attention(q, k, v, causal=True,
                           sliding_window=cfg.sliding_window,
                           impl=cfg.attn_impl)
        x = _block_rest(p, x, y, attn, cfg)
    x = L.rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return L.unembed(params, x, cfg)[:, -1].argmax(dim=-1)


def _decode_step(params, k_pool, v_pool, tokens, pos, table, *, cfg,
                 page_tokens: int):
    """One token for B sequences against the paged cache.  tokens [B, 1],
    pos [B] (the position being written), table [B, PP] (clamped >= 0)."""
    x = L.embed(params, tokens, cfg)
    lengths = (pos + 1).to(torch.int32)
    pages = torch.gather(table, 1, (pos // page_tokens)[:, None])
    slots = (pos % page_tokens)[:, None]
    table32 = table.to(torch.int32)
    for li in range(cfg.n_layers):
        p = layer(params, li)
        y = L.rms_norm(x, p["ln"], cfg.norm_eps)
        q, k, v = L.qkv(p, y, cfg, pos[:, None])
        # write this token's K/V into its page, then attend over the pages
        _scatter_pages(k_pool[li], k, pages, slots)
        _scatter_pages(v_pool[li], v, pages, slots)
        attn = paged_attention(q[:, 0], k_pool[li], v_pool[li], table32,
                               lengths)
        x = _block_rest(p, x, y, attn[:, None], cfg)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.unembed(params, x, cfg)[:, -1].argmax(dim=-1)
