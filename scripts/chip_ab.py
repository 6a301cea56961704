"""Compare two checkouts on one card: the serve phase of chip_smoke.py,
run in turns.

  python3 scripts/chip_ab.py PARENT_DIR [--pairs 10]

PARENT_DIR holds the parent commit (for example ``git archive`` unpacked
into a git-ignored directory of this checkout); the change is the checkout
this script lives in.  Pair i runs the parent first when i is odd and the
change first when it is even, each as ``python3 chip_smoke.py serve`` in a
process of its own.  From each run's ``[serve]`` line it takes the mean
decode ms per step and the median prefill ms of the requests after the
first two (the first carries the warm-up), then prints every run, the
median and quartiles of each side, and how many pairs the change won
(lower is better).
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys

CHANGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def serve_run(checkout: str) -> dict:
    proc = subprocess.run([sys.executable, "chip_smoke.py", "serve"],
                          cwd=checkout, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: chip_smoke.py serve failed\n"
                           f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("[serve]"))
    prefill = [float(x) for x in
               re.search(r"prefill_ms=\[([^\]]*)\]", line).group(1)
               .split(",")]
    return {"decode_ms": float(re.search(r"decode_ms_per_step=([\d.]+)",
                                         line).group(1)),
            "prefill_ms": statistics.median(prefill[2:]),
            "tokens_per_s": float(re.search(r"tokens_per_s=([\d.]+)",
                                            line).group(1))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    sides = {"parent": os.path.abspath(args.parent), "change": CHANGE}
    runs = {"parent": [], "change": []}
    for i in range(1, args.pairs + 1):
        order = ("parent", "change") if i % 2 else ("change", "parent")
        for side in order:
            r = serve_run(sides[side])
            runs[side].append(r)
            print(f"[ab] pair={i} side={side} " + " ".join(
                f"{k}={v:.3f}" for k, v in r.items()), flush=True)
    for metric in ("decode_ms", "prefill_ms"):
        for side in ("parent", "change"):
            vals = [r[metric] for r in runs[side]]
            q1, med, q3 = statistics.quantiles(vals, n=4)
            print(f"[ab] {metric} {side}: median={statistics.median(vals):.3f}"
                  f" q1={q1:.3f} q3={q3:.3f}")
        wins = sum(c[metric] < p[metric]
                   for c, p in zip(runs["change"], runs["parent"]))
        print(f"[ab] {metric}: change lower in {wins}/{args.pairs} pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
