"""Training cells: the program's train step fed by its WTF data pipeline,
and the check of its first steps against the reference.

Set-up writes the corpus from the seed into a WTF cluster under
``TMPDIR``, draws the weights, builds the one train step and its state,
and drives it through its first steps with the same call the window makes
(``next(pipeline)``, the host-to-device copy, ``train_step``, the loss read
back, as ``Trainer.run`` does at every logged step).  The window runs that
call until it closes; it ends on the last step's synchronisation.
"""
from __future__ import annotations

import gc
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from . import traffic, weights
from ..reference import dense as ref


def clone(tree: Dict) -> Dict[str, torch.Tensor]:
    """Copies of a tree's leaves, by path."""
    return {k: v.detach().clone() for k, v in ref.leaves(tree).items()}


class Job:
    """The cluster, the pipeline, and the one train step with its state."""

    def __init__(self, config: Dict, mix: Dict, seed: int, device):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.core import Cluster
        from repro_torch.data.pipeline import DataPipeline, PipelineConfig
        from repro_torch.data.records import RecordWriter
        from repro_torch.models import get_model
        from repro_torch.train import optimizer as opt
        from repro_torch.train.step import TrainHyper, make_train_step

        self.device = device
        self.m = m = weights.sizes(config)
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
        cfg = ModelConfig(name=config["name"], arch_kind="dense",
                          param_dtype=t["param_dtype"],
                          compute_dtype=t["compute_dtype"],
                          attn_impl=t["attn_impl"], remat=t["remat"],
                          accum_steps=mix["accum_steps"], **m)
        params = weights.draw(m, seed, getattr(torch, t["param_dtype"]),
                              device)
        self.state = {"params": params, "opt": opt.init(params),
                      "step": torch.zeros((), dtype=torch.int32,
                                          device=device)}
        self.step_fn = make_train_step(get_model(cfg), TrainHyper(
            adamw=opt.AdamWConfig(**t["adamw"]),
            accum_steps=mix["accum_steps"]))
        self.batches: List[tuple] = []    # (tokens, labels) handed out
        self.spans: List[tuple] = []
        self.record = False

    def step(self) -> Dict[str, float]:
        """One step as the window takes it; the loss is read back."""
        t0 = time.perf_counter()
        raw = next(self.it)
        batch = {k: torch.from_numpy(np.array(raw[k])).to(self.device)
                 for k in ("tokens", "labels")}
        t1 = time.perf_counter()
        self.state, metrics = self.step_fn(self.state, batch)
        loss = float(metrics["loss"])
        t2 = time.perf_counter()
        if self.record:
            self.spans.append(("pipeline.next", t0, t1, 0))
            self.spans.append(("train_step", t1, t2, 0))
        self.batches.append((np.array(raw["tokens"]),
                             np.array(raw["labels"])))
        return {"loss": loss, "grad_norm": float(metrics["grad_norm"])}

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
    job = Job(config, mix, seed, device)
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
        steps = 0
        while time.perf_counter() < start + seconds:
            job.step()
            steps += 1
        end = time.perf_counter()       # the last step's loss is read back
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
    ctx = {"sizes": job.m, "spans": job.spans, "steps": steps,
           "batch": mix["global_batch"],
           "seq_len": mix["seq_len"], "accum_steps": mix["accum_steps"]}
    # the program's state goes before the reference runs
    del job, m1, p3
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    refr = reference_steps(h, ctx["sizes"], p0, checked, device)
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
            "fp8": reference_steps(h, ctx["sizes"], p0, checked, device,
                                   fp8=True),
            "half_batch": reference_steps(h, ctx["sizes"], p0, half,
                                          device)}
        out["faults"] = {k: gaps(out["readings"][k], refr)
                         for k in ("fp8", "half_batch")}
    return out


def reference_steps(h: Dict, m: Dict, p0: Dict[str, torch.Tensor],
                    batches: List[tuple], device, fp8: bool = False
                    ) -> Dict:
    """The reference's first steps from the same weights and batches
    (``fp8``: the control), read as the program's are: each step's loss,
    the first step's global gradient norm before clipping, each leaf's
    first gradient as the optimizer took it (clipped), and each leaf's
    change over the steps."""
    ref.exact_fp32()
    params = {k: v.float().clone() for k, v in p0.items()}
    state: Dict = {}
    out: Dict = {"losses": []}
    for i, (tok, lab) in enumerate(batches, start=1):
        loss, g = ref.grads(_tree(params), m,
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


def _tree(flat_params: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {"layers": {}}
    for k, v in flat_params.items():
        if k.startswith("layers/"):
            tree["layers"][k[len("layers/"):]] = v
        else:
            tree[k] = v
    return tree
