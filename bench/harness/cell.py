"""One run of one cell, and its result line.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names
its configuration (``configs/<name>.json``) and traffic mix
(``traffic/<name>.json``); the configuration names its model family
(``families/<family>.py``) and its plain reference (``family.py``); its
limits are ``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``.  A new cell, metric or model family is new files
and entries, and no edit here.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from . import serve, traffic, train, weights

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def benchmark() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def limits(cell: str) -> Dict[str, float]:
    with open(os.path.join(BENCH_DIR, "limits", f"{cell}.json")) as f:
        return json.load(f)["limits"]


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read(ctx)``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def percentile(values: List[float], p: float) -> float:
    """The ``p``-th percentile, by linear interpolation."""
    return float(np.percentile(np.asarray(values, float), p))


def judge(checks: Dict, lim: Dict, failed: int) -> bool:
    """``correct``: no request failed, and every number compared is within
    its limit."""
    return failed == 0 and all(checks[k] is not None and checks[k] <= lim[k]
                               for k in lim)


def run(name: str, seed: int, seconds: float, trace: bool, device,
        t_process: Optional[float] = None, bench: Optional[Dict] = None,
        config: Optional[Dict] = None, mix: Optional[Dict] = None,
        lim: Optional[Dict] = None, control: bool = False) -> Dict:
    """One run of cell ``name``; ``config``, ``mix`` and ``lim`` stand in
    for the cell's configuration, traffic and limits files (the CPU tests'
    small sizes, and limits set from their readings).  ``control``: the
    line also holds, under ``controls``, the numbers of the fp8 control
    put in the program's place (and, for training, of a step that left
    half the batch out), each judged as the program's are."""
    bench = bench or benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    config = config or weights.load_config(cell["config"])
    mix = mix or traffic.load(cell["traffic"])
    tracer = None
    if trace and device.type == "cuda":
        from .trace import Window
        tracer = Window()
    if mix["kind"] == "serve":
        out = serve.run(config, mix, seed, seconds, device, tracer,
                        t_process, control)
        n = out["nums"]
        # a request that never got its first token counts with the wait
        # it had when the drain gave up
        e2e = {"ttft_p90_ms": percentile(n["ttft_ms"] + n["late_ms"], 90),
               "itl_p95_ms": percentile(n["itl_ms"], 95),
               "output_tok_s": n["tokens"] / seconds}
        # no finished request to compare: no reading, and not correct
        widest = {k: float(v.max()) for k, v in out["gaps"].items()}
        checks = {"widest_gap_std": widest.get("fp32")}
        controls = {"fp8": {"widest_gap_std": widest.get("fp8")}}
        attempted, failed = n["due"], len(n["late_ms"])
    else:
        out = train.run(config, mix, seed, seconds, device, tracer,
                        t_process, control)
        e2e = {"train_tok_s": out["tokens"] / out["window_s"]}
        checks = out["checks"]
        controls = {k: {**v, "rows_not_in_corpus":
                        checks["rows_not_in_corpus"]}
                    for k, v in out.get("faults", {}).items()}
        attempted, failed = out["steps"], 0
    e2e["setup_s"] = out["setup_s"]
    lim = lim or limits(name)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    line: Dict = {"correct": judge(checks, lim, failed),
                  "attempted": attempted, "failed": failed}
    ctx = dict(out["ctx"])
    # the spans' perf clock → the profiler's epoch clock
    ctx["epoch_offset_ns"] = time.time_ns() - int(time.perf_counter() * 1e9)
    if tracer is not None:
        ctx["trace"] = tracer.read()
    if trace:
        vals = per_layer(bench, name, ctx)
    else:
        vals = {k: v for k, v in e2e.items() if v is not None}
    line["metrics"] = {k: {"value": v, "unit": units[k]}
                       for k, v in vals.items()}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_name(device), "count": 1,
           "memory_peak_bytes": out["peak"]}
    if "trace" in ctx:
        t = ctx["trace"]
        dev.update(busy_s=t.busy_s(), window_s=t.window_s)
        line["breakdown"] = {"device_ops": t.top_ops(),
                             "idle_gaps": t.idle_gaps(
                                 ctx["spans"], ctx["epoch_offset_ns"])}
    line["device"] = dev
    if control:
        line["controls"] = {
            k: {"correct": judge(c, lim, failed),
                "checks": {n: {"value": c[n], "limit": lim[n]}
                           for n in lim}}
            for k, c in controls.items()}
        # every number read, compared or not
        line["readings"] = {"program": checks, **controls}
    line["checks"] = {k: {"value": checks[k], "limit": lim[k]}
                      for k in lim}
    return line


def per_layer(bench: Dict, cell: str, ctx: Dict) -> Dict[str, float]:
    """The per-layer metrics that list this cell (or list none), each
    read by its own reader; a reader that finds nothing is left out."""
    out = {}
    for m in bench["per_layer"]:
        if cell not in m.get("workloads", [cell]):
            continue
        v = reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = v
    return out


def device_name(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
