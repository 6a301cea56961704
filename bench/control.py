"""The readings that a cell's limits are set from, and the control judged
by them: the program's numbers on many seeds, and the control's on the
same runs.

    python3 bench/control.py --workload <cell> --seconds <s> \\
        --seeds 1,2,3 [--out readings.json]

Each seed is one run as ``run.py`` makes it (set-up, a window at the
cell's own load, the check), in one process, and its line carries the
controls beside the program's checks, each judged by the cell's limits
file with ``run.py``'s own ``correct``.  Serving cells: the widest gap of
the program's served tokens under the fp32 reference, and that of the fp8
control (the reference with every weight product in float8 e4m3) at the
same positions.  Training cells: the program's numbers, those of the fp8
control run in its place, and those of a step that leaves half of the
batch out (the reference on half the rows).  ``run.py`` never runs the
control.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    from bench.harness import cell

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = cell.run(args.workload, seed, args.seconds, False, device,
                        control=True)
        r = {"seed": seed, "seconds": time.perf_counter() - t0,
             "correct": {"program": line["correct"],
                         **{k: c["correct"]
                            for k, c in line["controls"].items()}},
             "readings": line["readings"]}
        readings.append(r)
        print(f"[control] {json.dumps(r)}", flush=True)
    for who in readings[0]["readings"]:
        print(f"[control] {who}: correct "
              f"{[r['correct'][who] for r in readings]}", flush=True)
        for num in readings[0]["readings"][who]:
            vals = sorted(r["readings"][who][num] for r in readings)
            print(f"[control] {who} {num}: max={vals[-1]!r} "
                  f"min={vals[0]!r} median={vals[len(vals) // 2]!r}",
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "seconds": args.seconds,
                       "readings": readings}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
