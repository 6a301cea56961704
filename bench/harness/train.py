"""Training cells: the program's train step fed by its WTF data pipeline,
and the check of its first steps against the reference.

Set-up writes the corpus from the seed into a WTF cluster under
``TMPDIR``, draws the weights, builds the one train step and its state,
and drives it through its first steps with the same call the window makes
(``next(pipeline)``, the copy to the card from pinned memory,
``train_step``, an event on the card after it), each step waited for and
its loss read back.  The window sends that call ahead of the card: it
waits only for the step ``ahead_steps`` back (the traffic file's; some
seconds of steps), so the card stays fed while the host stalls.  When its
time is up it sends nothing more, waits for every step sent, and reads the
clock after that wait: every step sent counts, over all of that time.
"""
from __future__ import annotations

import collections
import gc
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from . import family, traffic, weights


def clone(tree: Dict) -> Dict[str, torch.Tensor]:
    """Copies of a tree's leaves, by path."""
    return {k: v.detach().clone() for k, v in weights.leaves(tree).items()}


class Job:
    """The cluster, the pipeline, and the one train step with its state."""

    def __init__(self, fam, config: Dict, mix: Dict, seed: int, device):
        from repro_torch.core import Cluster
        from repro_torch.data.pipeline import DataPipeline, PipelineConfig
        from repro_torch.data.records import RecordWriter
        from repro_torch.models import get_model
        from repro_torch.train import optimizer as opt
        from repro_torch.train.step import TrainHyper, make_train_step

        self.device = device
        self.m = m = fam.sizes(config)
        t = config["training"]
        b, s = mix["global_batch"], mix["seq_len"]
        self.data_dir = tempfile.mkdtemp(prefix="bench_wtf_")
        c = mix["cluster"]
        self.cluster = Cluster(n_servers=c["n_servers"],
                               data_dir=self.data_dir,
                               replication=c["replication"],
                               region_size=c["region_bytes"])
        fs = self.cluster.client()
        fs.mkdir("/corpus")
        self.corpus = traffic.corpus(m["vocab"], mix["corpus_steps"] * b,
                                     s + 1, seed)
        w = RecordWriter(fs, "/corpus/shard0", (s + 1) * 4)
        for i in range(0, len(self.corpus), 64):
            w.append_many([r.tobytes() for r in self.corpus[i:i + 64]])
        w.close()
        self.pipeline = DataPipeline(fs, PipelineConfig(
            src_paths=("/corpus/shard0",), work_dir="/epochs",
            block_tokens=s + 1, global_batch=b, seed=seed % 2**31))
        self.it = iter(self.pipeline)
        cfg = fam.program_config(config, m, "training",
                                 accum_steps=mix["accum_steps"])
        params = weights.draw(fam.shapes(m), seed,
                              getattr(torch, t["param_dtype"]), device)
        self.state = {"params": params, "opt": opt.init(params),
                      "step": torch.zeros((), dtype=torch.int32,
                                          device=device)}
        self.step_fn = make_train_step(get_model(cfg), TrainHyper(
            adamw=opt.AdamWConfig(**t["adamw"]),
            accum_steps=mix["accum_steps"]))
        self.batches: List[tuple] = []    # (tokens, labels) handed out
        self.pending: collections.deque = collections.deque()
        self.spans: List[tuple] = []
        self.done: List = []    # each window step's end: event or time
        self.record = False

    def event(self):
        """A timing event recorded on the card now (None on the CPU, where
        a step has ended when its call returns)."""
        if self.device.type != "cuda":
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def upload(self, rows: np.ndarray) -> torch.Tensor:
        """Rows to the card from pinned memory, without waiting for it."""
        t = torch.from_numpy(rows)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def send(self, ahead: int) -> Dict[str, torch.Tensor]:
        """One step as set-up and the window take it, then a wait for the
        step ``ahead`` steps back (0: this one).  Returns the step's
        metrics, still on the card."""
        t0 = time.perf_counter()
        raw = next(self.it)
        batch = {k: self.upload(np.array(raw[k]))
                 for k in ("tokens", "labels")}
        t1 = time.perf_counter()
        self.state, metrics = self.step_fn(self.state, batch)
        end = self.event()
        self.pending.append(end)
        self.drain(ahead)
        t2 = time.perf_counter()
        if self.record:
            self.spans.append(("pipeline.next", t0, t1, 0))
            self.spans.append(("train_step", t1, t2, 0))
            self.done.append(t2 if end is None else end)
        self.batches.append((np.array(raw["tokens"]),
                             np.array(raw["labels"])))
        return metrics

    def drain(self, ahead: int = 0) -> None:
        """Waits until at most ``ahead`` steps sent have not ended."""
        while len(self.pending) > ahead:
            e = self.pending.popleft()
            if e is not None:
                e.synchronize()

    def step(self) -> Dict[str, float]:
        """One step waited for; its loss is read back."""
        metrics = self.send(0)
        return {"loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"])}

    def step_ends(self, opened, start: float) -> List[float]:
        """Each window step's end on the perf clock: from the card's events
        after the last wait, taking the window's open (``opened``, recorded
        on an idle card) as ``start``."""
        return [d if opened is None else start + opened.elapsed_time(d) / 1e3
                for d in self.done]

    def close(self) -> None:
        self.it.close()
        self.cluster.close()
        shutil.rmtree(self.data_dir, ignore_errors=True)


def rows_not_in_corpus(job: Job) -> int:
    """Rows handed out that are not records of the corpus the benchmark
    wrote, or whose labels are not its tokens shifted by one."""
    known = {r.tobytes() for r in job.corpus}
    return sum(1 for tok, lab in job.batches for t, l in zip(tok, lab)
               if not np.array_equal(t[1:], l[:-1])
               or np.concatenate([t, l[-1:]]).tobytes() not in known)


def run(config: Dict, mix: Dict, seed: int, seconds: float, device,
        tracer=None, t_process: float = None, control: bool = False) -> Dict:
    """One training run: set-up and its checked steps, the window, the
    check (``control``: also the readings of the fp8 control and of a
    step that left half the batch out, each as the program's would be)."""
    fam, ref = family.of(config), family.reference(config)
    job = Job(fam, config, mix, seed, device)
    try:
        p0 = clone(job.state["params"])
        first = [job.step()]
        m1 = clone(job.state["opt"].m)
        first += [job.step() for _ in range(mix["checked_steps"] - 1)]
        p3 = clone(job.state["params"])
        checked = list(job.batches)
        if tracer is not None:
            tracer.start()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        start = time.perf_counter()
        setup_s = start - t_process if t_process is not None else None
        if tracer is not None:
            tracer.mark_open()
        job.record = True
        opened = job.event()
        steps = 0
        while time.perf_counter() < start + seconds:
            job.send(mix["ahead_steps"])
            steps += 1
        job.drain()
        end = time.perf_counter()       # every step sent has ended
        ends = job.step_ends(opened, start)
        if tracer is not None:
            tracer.stop()
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0
        bad_rows = rows_not_in_corpus(job)
    finally:
        job.close()
    h = config["training"]["adamw"]
    prog = {"losses": [f["loss"] for f in first],
            "grad_norm": first[0]["grad_norm"],
            "grad": {k: float(v.norm()) / (1 - h["b1"])
                     for k, v in m1.items()},
            "grad_t": {k: v / (1 - h["b1"]) for k, v in m1.items()},
            "update": {k: float((p3[k] - p0[k]).norm()) for k in p0},
            "update_t": {k: p3[k] - p0[k] for k in p0}}
    ctx = {"sizes": job.m, "family": fam, "spans": job.spans, "steps": steps,
           "window_start": start, "step_ends": ends,
           "batch": mix["global_batch"],
           "seq_len": mix["seq_len"], "accum_steps": mix["accum_steps"]}
    # the program's state goes before the reference runs
    del job, m1, p3
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    refr = reference_steps(ref, h, ctx["sizes"], p0, checked, device)
    checks = gaps(prog, refr)
    checks["rows_not_in_corpus"] = bad_rows
    out = {"steps": steps, "window_s": end - start,
           "tokens": steps * mix["global_batch"] * mix["seq_len"],
           "setup_s": setup_s, "peak": peak, "checks": checks, "ctx": ctx}
    if control:
        half = [(tok[: len(tok) // 2], lab[: len(lab) // 2])
                for tok, lab in checked]
        out["readings"] = {
            "program": prog, "fp32": refr,
            "fp8": reference_steps(ref, h, ctx["sizes"], p0, checked,
                                   device, fp8=True),
            "half_batch": reference_steps(ref, h, ctx["sizes"], p0, half,
                                          device)}
        out["faults"] = {k: gaps(out["readings"][k], refr)
                         for k in ("fp8", "half_batch")}
    return out


def reference_steps(ref, h: Dict, m: Dict, p0: Dict[str, torch.Tensor],
                    batches: List[tuple], device, fp8: bool = False
                    ) -> Dict:
    """The first steps of the reference ``ref`` from the same weights and
    batches (``fp8``: the control), read as the program's are: each step's
    loss, the first step's global gradient norm before clipping, each
    leaf's first gradient as the optimizer took it (clipped), and each
    leaf's change over the steps."""
    ref.exact_fp32()
    params = {k: v.float().clone() for k, v in p0.items()}
    state: Dict = {}
    out: Dict = {"losses": []}
    for i, (tok, lab) in enumerate(batches, start=1):
        loss, g = ref.grads(weights.tree(params), m,
                            torch.from_numpy(tok).to(device),
                            torch.from_numpy(lab).to(device), fp8)
        gn = ref.adamw(h, params, g, state, i)
        if i == 1:
            scale = min(1.0, h["grad_clip"] / (gn + 1e-9))
            out["grad_t"] = {k: v * scale for k, v in g.items()}
            out["grad"] = {k: float(v.norm()) for k, v in
                           out["grad_t"].items()}
            out["grad_norm"] = gn
        out["losses"].append(loss)
        del g
    out["update_t"] = {k: params[k] - p0[k] for k in params}
    out["update"] = {k: float(v.norm()) for k, v in out["update_t"].items()}
    return out


def gaps(prog: Dict, refr: Dict) -> Dict[str, float]:
    """The numbers read: each step's loss, the global gradient norm, by the
    worst leaf the first gradient's norm and the norm of its difference
    from the reference's, and by the worst leaf the change's norm and the
    norm of its difference from the reference's change, each as a share of
    the reference's (a leaf's against the larger of its own and the median
    leaf's).  A leaf whose reference gradient is under a
    thousandth of the median leaf's is left out of the leaf numbers.  The
    cell's limits file says which are compared."""
    g = refr["grad"]
    med = float(np.median(list(g.values())))
    moved = [k for k in g if g[k] >= 1e-3 * med]
    med_u = float(np.median([refr["update"][k] for k in moved]))

    def leaf_gaps(what, floor):
        return [abs(prog[what][k] - refr[what][k])
                / max(refr[what][k], floor) for k in moved]

    def diff(what, norms, floor):
        return max(float((prog[what][k] - refr[what][k]).norm())
                   / max(norms[k], floor) for k in moved)

    return {"loss_gap": max(abs(a - r) / abs(r) for a, r in
                            zip(prog["losses"], refr["losses"])),
            "grad_norm_gap": abs(prog["grad_norm"] - refr["grad_norm"])
            / refr["grad_norm"],
            "grad_leaf_gap": max(leaf_gaps("grad", med)),
            "grad_diff_leaf_gap": diff("grad_t", g, med),
            "update_leaf_gap": max(leaf_gaps("update", med_u)),
            "update_diff_leaf_gap": diff("update_t", refr["update"], med_u)}

