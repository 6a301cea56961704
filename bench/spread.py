"""Run one cell several times, each run a fresh process, and report each
metric's median and spread: the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) as a share of the median.

    python3 bench/spread.py --workload <cell> --seconds <s> \\
        --seeds 11,12,13 [--trace 1] [--out results.json]

What bounds in ``BENCHMARK.json`` are set from.  Runs one process at a
time, so each has the card to itself.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values):
    """(median, quartile spread as a share of the median)."""
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    runs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, os.path.join(ROOT, "bench", "run.py"),
             "--workload", args.workload, "--seed", str(seed),
             "--seconds", str(args.seconds), "--trace", str(args.trace)],
            cwd=ROOT, capture_output=True, text=True, timeout=1500)
        wall = time.perf_counter() - t0
        line = None
        if p.returncode == 0 and p.stdout.strip():
            line = json.loads(p.stdout.strip().splitlines()[-1])
        runs.append({"seed": seed, "rc": p.returncode, "wall_s": wall,
                     "line": line, "stderr": p.stderr[-3000:]})
        print(f"[spread] seed={seed} rc={p.returncode} wall_s={wall:.1f} "
              f"line={json.dumps(line)}", flush=True)
        if line is None:
            print(p.stderr[-3000:], flush=True)
    names = sorted({k for r in runs if r["line"]
                    for k in r["line"]["metrics"]})
    summary = {}
    for k in names:
        vals = [r["line"]["metrics"][k]["value"] for r in runs
                if r["line"] and k in r["line"]["metrics"]]
        med, sp = spread(vals)
        summary[k] = {"median": med, "spread": sp, "values": vals}
        print(f"[spread] {k}: median={med!r} spread={sp:.5f} "
              f"values={vals}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "runs": runs,
                       "summary": summary}, f, indent=1)
    return 0 if all(r["line"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
