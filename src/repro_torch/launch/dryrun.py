"""Multi-pod dry-run: trace every (arch × shape × mesh) cell against the
production meshes and record memory, cost and collective artifacts (the
port of the JAX package's ``launch/dryrun.py``).

The JAX dry-run lowers and compiles each step for 512 forced host
devices.  Here each cell's step runs once, op by op, on ``device="meta"``
DTensors over a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``: no data, no
communication), as rank 0, under `repro_torch.roofline.cost.CostMode`.
The fake group is created inside `run_cell`/`main` (through `fake_world`),
never at import.

The record has the JAX record's keys, with these changes:
  * ``memory``: ``argument_bytes`` and ``output_bytes`` are exact, from
    rank 0's local shard shapes; ``alias_bytes`` is the part of the output
    that is the arguments' own storage (the train step updates the state in
    place); ``temp_bytes`` is the peak of the live bytes the step's ops
    allocate (`Analysis.peak_bytes`);
  * ``counted_flops`` / ``counted_bytes`` (JAX: ``xla_cost_flops`` /
    ``xla_cost_bytes``): the same formulas over the ops at their global,
    unsharded shapes, what one device would do for the whole program (a
    body that each rank runs on its own shards, `map_shards`, counts
    once per shard);
  * ``flops_per_device`` / ``bytes_per_device`` (JAX:
    ``hlo_flops_per_device`` / ``hlo_bytes_per_device``): the counts over
    rank 0's local ops;
  * ``collectives``: kind, operand bytes, group size and count, as JAX's;
  * ``replicated``: the ops DTensor had no sharding strategy for, each run
    on replicated operands, with its count (their collectives are in
    ``collectives``);
  * ``trace_s`` replaces ``lower_s``/``compile_s``, and there is no
    ``hlo_bytes``;
  * ``torch_version``: the torch that traced the cell (DTensor's choice
    of strategy, and so the counts, can differ between versions).
``--reanalyze`` has no counterpart: there is no stored HLO to walk again.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both [--force]
      [--jobs N]
``--jobs N`` runs each cell in a process of its own, N at a time, the
xLSTM cells first (their time loops take longest to trace).
Artifacts land in artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json and
are skipped if present (delete or --force to redo); the roofline table is
made from them by `repro_torch.roofline.report`.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils._pytree import tree_flatten

from ..configs import ARCHS, SHAPES, get_config, get_shape
from ..models import get_model
from ..models.common import decode_window
from ..parallel.sharding import distribute, make_rules, placements, spec_for
from ..roofline.cost import count
from ..train import (TrainHyper, abstract_state, make_prefill_step,
                     make_serve_step, make_train_step)
from ..train.optimizer import OptState
from .mesh import make_production_mesh, mesh_devices

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" \
    / "dryrun_torch"


def cell_config(arch: str, shape_name, cfg=None):
    """Per-cell config adjustments, as in the JAX package:
    - long_500k applies `long_context_window` to attention sites;
    - whisper decode cells size the learned-position table to seq_len;
    - the dry-run always takes the einsum attention path ("xla"; meta
      tensors would take the kernels' plain versions anyway);
    - serving cells hold bf16 params (no fp32 master copy).
    ``shape_name`` may also be a `ShapeConfig` of its own, and ``cfg`` a
    config other than the arch's published one (a smoke config)."""
    cfg = cfg or get_config(arch)
    shape = get_shape(shape_name) if isinstance(shape_name, str) \
        else shape_name
    shape_name = shape.name
    cfg = cfg.replace(attn_impl="xla")
    if shape_name == "long_500k" and cfg.long_context_window is not None:
        cfg = cfg.replace(sliding_window=cfg.long_context_window)
    if cfg.encdec is not None or cfg.max_seq < shape.seq_len:
        cfg = cfg.replace(max_seq=max(shape.seq_len, cfg.max_seq))
    if shape.kind in ("prefill", "decode"):
        cfg = cfg.replace(param_dtype="bfloat16")
    return cfg, shape


def batch_shardings(specs, mesh, rules):
    """First dim of every input is the global batch: its placements."""
    return {k: placements(spec_for(("batch",) + (None,) * (s.ndim - 1),
                                   rules), mesh)
            for k, s in specs.items()}


def skip_reason(cfg, shape_name: str):
    if shape_name == "long_500k" and not cfg.subquadratic:
        return ("full-attention arch: 500k decode requires sub-quadratic "
                "attention — skipped per DESIGN.md §Arch-applicability")
    return None


def fit_batch_rule(mesh, rules, global_batch: int):
    """Shrink the batch mapping until it divides the global batch
    (long_500k has batch=1 — everything batch-wise is replicated)."""
    axis_size = dict(zip(mesh.mesh_dim_names, mesh.shape))
    rule = rules.get("batch")
    if rule is None:
        return rules
    axes = rule if isinstance(rule, tuple) else (rule,)
    while axes:
        n = 1
        for a in axes:
            n *= axis_size[a]
        if global_batch % n == 0:
            break
        axes = axes[1:]
    rules = dict(rules)
    rules["batch"] = axes if axes else None
    return rules


def _dim(mesh, name: str) -> int:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))[name]


def cell_rules(cfg, shape, mesh, hyper) -> dict:
    """The logical rules of a cell (``cfg`` and ``shape`` from
    `cell_config`) on ``mesh``: the arch's rules, with the batch rule
    fitted, sequence parallelism for a prefill whose heads do not shard,
    and the split-K window for decode."""
    rules = make_rules(mesh, **dict(cfg.rules_overrides))
    # fitted to what one step computes on: a train step's microbatch.  JAX
    # fits the global batch and pads a microbatch its batch axes do not
    # divide; DTensor cannot fold such a dim into another (the flatten
    # before each matmul), so the port shards the microbatch evenly
    micro = shape.global_batch // (hyper.accum_steps
                                   if shape.kind == "train" else 1)
    rules = fit_batch_rule(mesh, rules, micro)
    if (shape.kind == "prefill" and rules.get("heads") is None
            and shape.seq_len % _dim(mesh, "model") == 0):
        # sequence parallelism: when the head count cannot shard on the
        # model axis, shard the sequence instead; the activation mlp/vocab
        # dims hand their model-axis mapping to seq (weights keep TP; one
        # mesh axis can't shard two dims of a tensor)
        rules["seq"] = "model"
        rules["act_mlp"] = None
        rules["act_vocab"] = None
    if shape.kind == "decode":
        # KV-parallel decode (split-K): shard the ring-cache window dim on
        # the model axis, unless the kv heads already shard there
        window = decode_window(cfg, shape.seq_len)
        if window % _dim(mesh, "model") == 0 \
                and rules.get("kv_heads") is None:
            rules["window"] = "model"
    return rules


def build_cell(arch: str, shape_name, mesh, hyper=None, cfg=None):
    """Returns (fn, args, meta): the cell's step and its arguments as meta
    DTensors placed on ``mesh``."""
    cfg, shape = cell_config(arch, shape_name, cfg)
    model = get_model(cfg)
    hyper = hyper or TrainHyper(accum_steps=cfg.accum_steps)
    rules = cell_rules(cfg, shape, mesh, hyper)
    schema = model.schema()
    inputs = model.input_specs(shape)
    input_pl = batch_shardings(inputs, mesh, rules)
    batch = {k: distribute_tensor(v, mesh, input_pl[k], src_data_rank=None)
             for k, v in inputs.items()}
    meta = {
        "arch": arch, "shape": shape.name, "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "params": model.param_count(),
        "active_params": model.active_param_count(),
        "accum_steps": hyper.accum_steps,
    }
    if shape.kind == "train":
        state = abstract_state(model)
        o = state["opt"]
        # moments mirror the param placements; count and step replicate
        state = {"params": distribute(state["params"], schema, mesh, rules),
                 "opt": OptState(distribute(o.m, schema, mesh, rules),
                                 distribute(o.v, schema, mesh, rules),
                                 o.count),
                 "step": state["step"]}
        return make_train_step(model, hyper, rules), (state, batch), meta
    params = distribute(model.abstract_params(), schema, mesh, rules)
    if shape.kind == "prefill":
        return make_prefill_step(model, rules), (params, batch), meta
    cache_schema = model.cache_schema(shape.global_batch, shape.seq_len)
    cache = distribute(model.abstract_cache(shape.global_batch,
                                            shape.seq_len),
                       cache_schema, mesh, rules)
    return make_serve_step(model, rules), (params, cache, batch), meta


def _leaves(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _memory(args, out, peak_bytes: int) -> dict:
    def nbytes(t):
        t = _local(t)
        return t.numel() * t.element_size()
    arg_leaves = _leaves(args)
    arg_ids = {_local(t).untyped_storage()._cdata for t in arg_leaves}
    out_leaves = _leaves(out)
    return {
        "argument_bytes": sum(nbytes(t) for t in arg_leaves),
        "output_bytes": sum(nbytes(t) for t in out_leaves),
        "temp_bytes": peak_bytes,
        "alias_bytes": sum(nbytes(t) for t in out_leaves
                           if _local(t).untyped_storage()._cdata in arg_ids),
    }


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks, this process rank 0, for
    the span of the block."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def analyze_cell(arch: str, shape_name, mesh, hyper=None,
                 cfg=None) -> dict:
    """Trace one cell on ``mesh``; the record's measured fields."""
    t0 = time.time()
    fn, args, meta = build_cell(arch, shape_name, mesh, hyper, cfg)
    out, ana = count(fn, *args)
    rec = dict(meta)
    rec.update({
        "status": "ok",
        "torch_version": torch.__version__,
        "chips": mesh_devices(mesh),
        "trace_s": round(time.time() - t0, 2),
        "memory": _memory(args, out, ana.peak_bytes),
        "counted_flops": ana.global_flops,
        "counted_bytes": ana.global_bytes,
        "flops_per_device": ana.flops,
        "bytes_per_device": ana.bytes_accessed,
        "bytes_by_op": ana.bytes_by_op,
        "collectives": ana.collective_ops,
        "replicated": ana.replicated,
    })
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             hyper=None, save: bool = True, verbose: bool = True):
    mesh_name = "multipod" if multi_pod else "pod"
    cfg, _ = cell_config(arch, shape_name)
    out = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    reason = skip_reason(cfg, shape_name)
    if reason:
        out.update({"status": "skip", "reason": reason})
        return _finish(out, save, verbose)
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            out.update(analyze_cell(arch, shape_name, mesh, hyper))
    except Exception as e:                       # noqa: BLE001
        out.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    return _finish(out, save, verbose)


def _finish(record, save, verbose):
    if save:
        ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
        artifact_path(record["arch"], record["shape"],
                      record["mesh"]).write_text(json.dumps(record,
                                                            indent=1))
    if verbose:
        s = record["status"]
        extra = ""
        if s == "ok":
            extra = (f" flops/dev={record['flops_per_device']:.3e}"
                     f" trace={record['trace_s']:.0f}s"
                     f" torch={record['torch_version']}")
            if record["replicated"]:
                extra += f" replicated={record['replicated']}"
        elif s == "error":
            extra = " " + record["error"][:200]
        print(f"[dryrun] {record['arch']} × {record['shape']} × "
              f"{record['mesh']}: {s}{extra}", flush=True)
    return record


def artifact_path(arch, shape_name, mesh_name) -> Path:
    return ARTIFACT_DIR / f"{arch}__{shape_name}__{mesh_name}.json"


def run_apart(cells, jobs: int) -> int:
    """Each (arch, shape, multi_pod) of ``cells`` through this module's
    command line in a process of its own, ``jobs`` at a time; prints each
    cell's line as it ends and returns the number that failed."""
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor

    def one(cell):
        arch, shape, multi = cell
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "multi" if multi else
             "single", "--force"], capture_output=True, text=True)
        lines = out.stdout.strip().splitlines()
        print(lines[-1] if lines else f"[dryrun] {arch} × {shape}: rc "
              f"{out.returncode}\n{out.stderr[-2000:]}", flush=True)
        return out.returncode != 0

    order = sorted(cells, key=lambda c: (c[0] != "xlstm-1.3b",
                                         list(SHAPES).index(c[1])))
    with ThreadPoolExecutor(jobs) as pool:
        return sum(pool.map(one, order))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run in processes of their own, this many "
                         "at a time")
    args = ap.parse_args()

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    archs = ARCHS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]

    todo = []
    for multi in meshes:
        mname = "multipod" if multi else "pod"
        for arch in archs:
            for shape in shapes:
                p = artifact_path(arch, shape, mname)
                if p.exists() and not args.force:
                    rec = json.loads(p.read_text())
                    if rec.get("status") in ("ok", "skip"):
                        print(f"[dryrun] cached {p.name}: "
                              f"{rec['status']}", flush=True)
                        continue
                todo.append((arch, shape, multi))
    if args.jobs > 1:
        failures = run_apart(todo, args.jobs)
    else:
        failures = sum(run_cell(*cell)["status"] == "error"
                       for cell in todo)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
