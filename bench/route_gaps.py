"""Where a routed-expert training cell's check reads its gaps: the
routing flips, or the rest of the arithmetic.

    python3 bench/route_gaps.py --workload <cell> --seeds 1,2,3 \\
        [--fp32-layers 4] [--out gaps.json]

For each seed the cell's checked steps are run once, as ``run.py``'s
set-up runs them (no window), with the program's routing logged
(`layers.ROUTE_LOG`), and read against the plain reference twice: with
the reference's own routing (the cell's numbers), and with the program's
choices given to it (``ROUTES_GIVEN``), so that the flips between the
two are taken out and what is left is rounding.  ``--fp32-layers n``
also runs the same at n layers in fp32 (einsum attention, TF32 off),
with the bf16 program at n layers beside it: the program's code against
the reference's, with next to no flips.  Each number comes with the leaf
that reads it, and each run with the share of choices whose expert
differs from the reference's own.
"""
import argparse
import gc
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def checked_steps(config, mix, seed, device):
    """The cell's checked steps from its set-up: (the program's readings
    as `train.run` takes them, the first weights, the batches, the
    program's choices of each expert layer in the order it ran them, the
    sizes)."""
    from bench.harness import family, train
    from repro_torch.models import layers as L

    job = train.Job(family.of(config), config, mix, seed, device)
    try:
        p0 = train.clone(job.state["params"])
        L.ROUTE_LOG = []
        first = [job.step()]
        m1 = train.clone(job.state["opt"].m)
        first += [job.step() for _ in range(mix["checked_steps"] - 1)]
        p3 = train.clone(job.state["params"])
        routes = [r["top_e"] for r in L.ROUTE_LOG]
    finally:
        L.ROUTE_LOG = None
        job.close()
    h = config["training"]["adamw"]
    prog = {"losses": [f["loss"] for f in first],
            "grad_norm": first[0]["grad_norm"],
            "grad": {k: float(v.norm()) / (1 - h["b1"])
                     for k, v in m1.items()},
            "grad_t": {k: v / (1 - h["b1"]) for k, v in m1.items()},
            "update": {k: float((p3[k] - p0[k]).norm()) for k in p0},
            "update_t": {k: p3[k] - p0[k] for k in p0}}
    return prog, p0, list(job.batches), routes, job.m


def as_run_here(routes, n_moe: int):
    """The program's choices in the order the reference's expert layers
    run: per microbatch the forward's layers, then their recompute in
    reverse."""
    out = []
    for i in range(0, len(routes), n_moe):
        chunk = routes[i:i + n_moe]
        out += chunk + chunk[::-1]
    return out


def worst_leaves(prog, refr, n: int = 3):
    """The ``n`` leaves that read the most in each leaf number of
    `train.gaps`, each with its reading, the worst first."""
    g = refr["grad"]
    med = float(np.median(list(g.values())))
    moved = [k for k in g if g[k] >= 1e-3 * med]
    med_u = float(np.median([refr["update"][k] for k in moved]))

    def top(gap):
        return sorted(((k, gap(k)) for k in moved), key=lambda kv: -kv[1])[:n]

    def leaf(what, floor):
        return top(lambda k: abs(prog[what][k] - refr[what][k])
                   / max(refr[what][k], floor))

    def diff(what, norms, floor):
        return top(lambda k: float((prog[what][k] - refr[what][k]).norm())
                   / max(norms[k], floor))

    return {"grad_leaf_gap": leaf("grad", med),
            "grad_diff_leaf_gap": diff("grad_t", g, med),
            "update_leaf_gap": leaf("update", med_u),
            "update_diff_leaf_gap": diff("update_t", refr["update"], med_u)}


def flip_share(ours, theirs) -> float:
    """The share of (token, choice) pairs whose expert the two runs'
    choices of the same layers differ on."""
    diff = total = 0
    for a, b in zip(ours, theirs):
        hit = (a[:, :, None] == b[:, None, :]).any(-1)
        diff += int((~hit).sum())
        total += hit.numel()
    return diff / max(total, 1)


def readings(config, mix, seed, device) -> dict:
    """The program's numbers against the reference with its own routing
    (``own``) and with the program's (``given``), each with its worst
    leaves and the share of choices flipped."""
    import torch
    from bench.harness import family, train

    ref = family.reference(config)
    prog, p0, batches, routes, m = checked_steps(config, mix, seed, device)
    # the program's state goes before the reference runs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    h = config["training"]["adamw"]
    n_moe = m["n_layers"] - m["first_k_dense"]
    out = {}
    for name in ("own", "given"):
        ref.ROUTE_LOG = []
        ref.ROUTES_GIVEN = as_run_here(routes, n_moe) if name == "given" \
            else None
        try:
            refr = train.reference_steps(ref, h, m, p0, batches, device)
            left = len(ref.ROUTES_GIVEN or ())
            theirs = [r["top_e"] for i, r in enumerate(ref.ROUTE_LOG)
                      if i % (2 * n_moe) < n_moe]
        finally:
            ref.ROUTE_LOG = ref.ROUTES_GIVEN = None
        if left or len(theirs) != len(routes):
            raise AssertionError(f"route_gaps: {len(routes)} routings of "
                                 f"the program, {len(theirs)} forwards of "
                                 f"the reference, {left} left over")
        out[name] = {"gaps": train.gaps(prog, refr),
                     "worst": worst_leaves(prog, refr),
                     "flip_share": flip_share(routes, theirs)}
        del refr
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fp32-layers", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    from bench.harness import cell, family, traffic, weights

    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    w = next(c for c in cell.benchmark()["workloads"]
             if c["name"] == args.workload)
    config, mix = weights.load_config(w["config"]), traffic.load(w["traffic"])
    runs = [("bf16", config)]
    if args.fp32_layers:
        cut = {**config, "num_hidden_layers": args.fp32_layers}
        runs += [(f"bf16@{args.fp32_layers}", cut),
                 (f"fp32@{args.fp32_layers}",
                  {**cut, "training": {**cut["training"],
                                       "compute_dtype": "float32",
                                       "attn_impl": "xla"}})]
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for name, cfg in runs:
            t0 = time.perf_counter()
            if cfg["training"]["compute_dtype"] == "float32":
                family.reference(cfg).exact_fp32()
            r = {"seed": seed, "run": name,
                 **readings(cfg, mix, seed, device),
                 "seconds": time.perf_counter() - t0}
            out.append(r)
            print(f"[route_gaps] {json.dumps(r)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "runs": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
