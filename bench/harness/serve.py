"""Serving cells: the program's ``Engine`` driven by a traffic mix, and the
check of what it served against the reference.

Set-up draws the weights, builds the engine, prefills each shared system
prompt once as a resident root sequence and warms up; the window then
admits every request that is due (``Engine.add``, forked from its root, or
whole where the mix has no shared prompts: the prefill, whose last logits
give the first token) and steps the engine
(``Engine.step``: one token for every running request) until the window
closes.  Open loop: requests fall due on the mix's Poisson schedule.  Time
to first token counts from when a request was due, so a stall shows in the
requests behind it.
"""
from __future__ import annotations

import gc
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import arith, family, traffic, weights


@dataclass
class Live:
    """One request as the benchmark saw it."""
    req: traffic.Request
    prompt: np.ndarray
    due: float                        # perf clock
    sid: int = -1
    times: List[float] = field(default_factory=list)   # one per token
    tokens: Optional[List[int]] = None                  # once finished
    finished: float = 0.0


class Server:
    def __init__(self, engine, mix: traffic.ServeMix, page_tokens: int):
        self.eng, self.mix = engine, mix
        self.roots = [engine.add(p, max_new=1) for p in mix.prefixes]
        # the tokens of each root's full pages, which its forks read in
        # place (the open page is copied on write)
        self.shared = {i: len(p) // page_tokens * page_tokens
                       for i, p in enumerate(mix.prefixes)}
        self.live: Dict[int, Live] = {}
        self.seen: List[Live] = []
        self.spans: List[tuple] = []      # (name, t0, t1, size, ...)
        self.steps: List[tuple] = []      # (t0, t1, rows, sum L, max L,
                                          #  unique K/V tokens)
        self.record = False

    def _admit(self, r: traffic.Request, due: float) -> Live:
        if r.prefix is None:
            prompt, root, cached = r.suffix, None, 0
        else:
            prefix = self.mix.prefixes[r.prefix]
            prompt = np.concatenate([prefix, r.suffix])
            root, cached = self.roots[r.prefix], len(prefix)
        lv = Live(r, prompt, due)
        t0 = time.perf_counter()
        lv.sid = self.eng.add(prompt, r.max_new, fork_from=root)
        t1 = time.perf_counter()
        lv.times.append(t1)
        if self.record:
            # the prompt's tokens, and those of them whose K/V the root
            # already holds
            self.spans.append(("engine.add", t0, t1, len(prompt), cached))
        self.seen.append(lv)
        self.live[lv.sid] = lv
        if r.max_new <= 1:
            self._finish(lv, t1)
        return lv

    def _finish(self, lv: Live, t: float) -> None:
        lv.tokens = list(self.eng.result(lv.sid))
        lv.finished = t
        self.eng.release(lv.sid)
        del self.live[lv.sid]

    def _step(self) -> List[Live]:
        rows = list(self.live.values())
        lengths = [len(lv.prompt) + len(lv.times) for lv in rows]
        t0 = time.perf_counter()
        finished = self.eng.step()
        t1 = time.perf_counter()
        if self.record:
            self.spans.append(("engine.step", t0, t1, len(rows)))
            self.steps.append((t0, t1, len(rows), sum(lengths), max(lengths),
                               arith.unique_kv_tokens(
                                   ((lv.req.prefix, n) for lv, n in
                                    zip(rows, lengths)), self.shared)))
        for lv in rows:
            lv.times.append(t1)
        done = [self.live[s] for s in finished]
        for lv in done:
            self._finish(lv, t1)
        return done

    def drive(self, queue: deque, end: float,
              completions: Optional[int] = None) -> None:
        """Admit what is due and step until ``end`` (perf clock) or until
        ``completions`` requests have finished.  ``queue`` holds (due,
        request) in order of due time."""
        finished = 0
        while time.perf_counter() < end and (completions is None
                                             or finished < completions):
            now = time.perf_counter()
            done = []
            while queue and queue[0][0] <= now:
                due, r = queue.popleft()
                lv = self._admit(r, due)
                if lv.tokens is not None:
                    done.append(lv)
            if self.live:
                done += self._step()
            elif queue:
                time.sleep(max(0.0, min(queue[0][0], end)
                               - time.perf_counter()))
            finished += len(done)

    def drain(self, queue: deque, end: float, limit_s: float) -> None:
        """After the window: admit the requests that fell due inside it
        and were still waiting, for their first tokens, for at most
        ``limit_s`` seconds."""
        stop = time.perf_counter() + limit_s
        while queue and queue[0][0] < end and time.perf_counter() < stop:
            due, r = queue.popleft()
            self._admit(r, due)


def warm_up(srv: Server, before_window=None) -> tuple:
    """Set-up's traffic, which brings the engine to the load the window
    measures; returns (the window's start, its queue).  First one request
    runs alone, so that the kernels are built and loaded before any
    schedule runs; then the schedule's first ``warmup_s`` seconds of
    arrivals.  ``before_window`` is called about a second before the
    window opens."""
    mix = srv.mix
    srv.drive(deque([(0.0, mix.warmup[0])]), float("inf"), completions=1)
    start = time.perf_counter() - mix.warmup[0].due
    q = deque((start + r.due, r) for r in mix.warmup + mix.requests)
    srv.drive(q, start - 1.0)
    if before_window is not None:
        before_window()
    srv.drive(q, start)
    return start, q


def metrics(srv: Server, start: float, end: float, queue: deque) -> Dict:
    """The window's end-to-end numbers from the requests' token times; a
    request due in the window that is still in ``queue`` never got its
    first token."""
    now = time.perf_counter()
    ttft, gaps, tokens = [], [], 0
    late = [(now - due) * 1e3 for due, _ in queue if start <= due < end]
    for lv in srv.seen:
        if start <= lv.due < end:
            ttft.append((lv.times[0] - lv.due) * 1e3)
        tokens += sum(1 for t in lv.times if start <= t < end)
        gaps += [(b - a) * 1e3 for a, b in zip(lv.times, lv.times[1:])
                 if start <= b < end]
    return {"ttft_ms": ttft, "late_ms": late, "due": len(ttft) + len(late),
            "itl_ms": gaps, "tokens": tokens}


def served_sample(srv: Server, start: float, end: float, want: int,
                  seed: int) -> List[Live]:
    """Requests finished in the window, drawn from the seed, the one with
    the most served tokens first, until they hold ``want`` served
    tokens."""
    done = [lv for lv in srv.seen
            if lv.tokens is not None and start <= lv.finished < end]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].tokens))
    out, n = [], 0
    for i in traffic.sample(len(done), len(done), seed, always=longest):
        out.append(done[i])
        n += len(done[i].tokens)
        if n >= want:
            break
    return out


def token_gaps(ref, params: Dict, m: Dict, sample: List[Live], device,
               modes=("fp32",)) -> Dict[str, torch.Tensor]:
    """For each served token of ``sample``: how far the logit of that
    token under the reference ``ref`` lies below the reference's best at
    its position, in standard deviations of that position's logits.
    With "fp8" among ``modes``, also the gap of the token that the
    control puts first."""
    seqs, rows, targets = [], [], []
    for lv in sample:
        full = np.concatenate([lv.prompt, lv.tokens[:-1]]).astype(np.int64)
        seqs.append(torch.from_numpy(full).to(device))
        rows.append(torch.arange(len(lv.prompt) - 1, len(full),
                                 device=device))
        targets.append(torch.tensor(lv.tokens, device=device))
    logits = ref.served_logits(params, m, seqs, rows, modes)
    out = {}
    for mode in modes:
        gaps = []
        for r, c, t in zip(logits["fp32"], logits[mode], targets):
            pick = t if mode == "fp32" else c.argmax(-1)
            best = r.max(-1).values
            gaps.append((best - r.gather(-1, pick[:, None])[:, 0])
                        / r.std(-1))
        out[mode] = torch.cat(gaps)
    return out


def build(fam, m: Dict, config: Dict, seed: int, device):
    """The program's engine over the benchmark's weights: the model
    config as the port names it (from the family ``fam``), the weights,
    the engine."""
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig
    s = config["serving"]
    cfg = fam.program_config(config, m, "serving")
    params = weights.draw(fam.shapes(m), seed,
                          getattr(torch, s["param_dtype"]), device)
    eng = Engine(get_model(cfg), params, EngineConfig(
        page_tokens=s["page_tokens"], num_pages=s["num_pages"],
        device=str(device)))
    return params, eng


def run(config: Dict, mix_spec: Dict, seed: int, seconds: float,
        device, tracer=None, t_process: float = None,
        control: bool = False) -> Dict:
    """One serving run: set-up, the window, the drain, the check
    (``control``: the fp8 control's gaps on the same sample too)."""
    fam, ref = family.of(config), family.reference(config)
    m = fam.sizes(config)
    params, eng = build(fam, m, config, seed, device)
    mix = traffic.serve_mix(mix_spec, m["vocab"], seed, seconds)
    srv = Server(eng, mix, config["serving"]["page_tokens"])
    start, queue = warm_up(srv, tracer.start if tracer is not None
                           else None)
    setup_s = start - t_process if t_process is not None else None
    if tracer is not None:
        tracer.mark_open()
    srv.record = True
    end = start + seconds
    srv.drive(queue, end)
    sync(device)
    if tracer is not None:
        tracer.stop()
    srv.record = False
    srv.drain(queue, end, limit_s=60.0)
    nums = metrics(srv, start, end, queue)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    sample = served_sample(srv, start, end, mix.sample_tokens, seed)
    ctx = {"sizes": m, "family": fam,
           "page_tokens": config["serving"]["page_tokens"],
           "spans": srv.spans, "steps": srv.steps}
    # the program's state goes before the reference runs
    srv.eng = eng = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref.exact_fp32()
    modes = ("fp32", "fp8") if control else ("fp32",)
    gaps = token_gaps(ref, params, m, sample, device, modes) \
        if sample else {}
    return {"nums": nums, "setup_s": setup_s, "peak": peak, "ctx": ctx,
            "gaps": gaps, "served_tokens": sum(len(lv.tokens)
                                               for lv in sample)}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
