"""Compare two checkouts on one card: phases of chip_smoke.py, run in
turns.

  python3 scripts/chip_ab.py PARENT_DIR [--pairs 10] [--phases serve]
  python3 scripts/chip_ab.py PARENT_DIR --pairs 2 --phases kernels
  python3 scripts/chip_ab.py PARENT_DIR --pairs 1 --phases serve profile

PARENT_DIR holds the parent commit (for example ``git archive`` unpacked
into a git-ignored directory of this checkout); the change is the checkout
this script lives in.  Both sides run this checkout's ``chip_smoke.py``,
each from its own root, so over its own ``src/``; nothing is written into
PARENT_DIR but what its kernels build.  Pair i runs the parent first when
i is odd and the change first when it is even, each as ``python3
chip_smoke.py PHASES`` in a process of its own.  From each run's output it takes the metrics below that the run
printed, then prints every run, the median and quartiles of each side, and
how many pairs the change won (lower is better):

- serve: mean decode ms per step, the median prefill ms of the requests
  after the first two (the first carries the warm-up), tokens/s;
- zamba2_serve: mean decode ms per step, the median prefill ms of the
  calls after the first;
- kernels: the paged kernel's device ms and the host us per call at the
  serve phase's decode shape, with a table of scattered pages and with
  the shared-prefix table;
- profile: the ``decode x8`` window's device busy ms and idle share, and
  the paged kernels' ms and share of the busy time in it;
- xlstm_train: the median step ms, the device busy ms, idle share and
  ops of one step, and the peak memory.
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys

CHANGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(CHANGE, "chip_smoke.py")
NUM = r"([\d.]+)"


def metrics(out: str) -> dict:
    found = {}
    for line in out.splitlines():
        if line.startswith("[serve]"):
            prefill = [float(x) for x in re.search(
                r"prefill_ms=\[([^\]]*)\]", line).group(1).split(",")]
            found["decode_ms"] = float(re.search(
                "decode_ms_per_step=" + NUM, line).group(1))
            found["prefill_ms"] = statistics.median(prefill[2:])
            found["tokens_per_s"] = float(re.search(
                " tokens_per_s=" + NUM, line).group(1))
        if line.startswith("[zamba2_serve]"):
            prefill = [float(x) for x in re.search(
                r"prefill_ms=\[([^\]]*)\]", line).group(1).split(",")]
            found["zamba2_decode_ms"] = float(re.search(
                "decode_ms_per_step=" + NUM, line).group(1))
            found["zamba2_prefill_ms"] = statistics.median(prefill[1:])
        m = re.match(r"\[kernels\] kernel=paged_attention timing=(\w+) ms="
                     + NUM + ".* host_us=" + NUM, line)
        if m:
            found[f"paged_{m.group(1)}_ms"] = float(m.group(2))
            found[f"paged_{m.group(1)}_host_us"] = float(m.group(3))
        m = re.match(r"\[xlstm_train\] step_ms=" + NUM + ".* device_busy_ms="
                     + NUM + " device_idle_share=" + NUM
                     + " device_ops_per_step=" + NUM + " peak_gb=" + NUM,
                     line)
        if m:
            for i, key in enumerate(("step_ms", "busy_ms", "idle_share",
                                     "ops", "peak_gb"), 1):
                found[f"xlstm_train_{key}"] = float(m.group(i))
        m = re.match(r"\[profile\] window=decode x8 .*device_busy_ms=" + NUM
                     + " device_idle_share=" + NUM, line)
        if m:
            found["decode_x8_busy_ms"] = float(m.group(1))
            found["decode_x8_idle_share"] = float(m.group(2))
        m = re.match(r"\[profile\] decode x8: +" + NUM + r" ms .*paged_", line)
        if m:
            found["decode_x8_paged_ms"] = (found.get("decode_x8_paged_ms", 0)
                                           + float(m.group(1)))
    if "decode_x8_paged_ms" in found:
        found["decode_x8_paged_share"] = (found["decode_x8_paged_ms"]
                                          / found["decode_x8_busy_ms"])
    return found


def run(checkout: str, phases: list) -> dict:
    proc = subprocess.run([sys.executable, SMOKE, *phases], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: chip_smoke.py {' '.join(phases)} "
                           f"failed\n{proc.stdout[-2000:]}"
                           f"{proc.stderr[-2000:]}")
    for line in proc.stdout.splitlines():
        if line.startswith(("[profile]", "[kernels] kernel=paged",
                            "[xlstm_train]")):
            print(f"  {os.path.basename(checkout)} {line}")
    return metrics(proc.stdout)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--phases", nargs="+", default=["serve"])
    args = ap.parse_args()
    sides = {"parent": os.path.abspath(args.parent), "change": CHANGE}
    runs = {"parent": [], "change": []}
    for i in range(1, args.pairs + 1):
        order = ("parent", "change") if i % 2 else ("change", "parent")
        for side in order:
            r = run(sides[side], args.phases)
            runs[side].append(r)
            print(f"[ab] pair={i} side={side} " + " ".join(
                f"{k}={v:.6g}" for k, v in r.items()), flush=True)
    for metric in runs["change"][0]:
        for side in ("parent", "change"):
            vals = [r[metric] for r in runs[side]]
            q1, q3 = (statistics.quantiles(vals, n=4)[::2] if len(vals) > 1
                      else (vals[0], vals[0]))
            print(f"[ab] {metric} {side}: median="
                  f"{statistics.median(vals):.6g} q1={q1:.6g} q3={q3:.6g}")
        wins = sum(c[metric] < p[metric]
                   for c, p in zip(runs["change"], runs["parent"]))
        print(f"[ab] {metric}: change lower in {wins}/{args.pairs} pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
