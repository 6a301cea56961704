"""Run one cell of the benchmark once, on the card, and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: the program under test is the checkout's
``src/repro_torch``.  With ``--trace 0`` the result line carries the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read from the
benchmark's spans and a ``torch.profiler`` trace of the window.  The last
lines on standard error, and the ``checks`` key that ends the result line,
give each number compared with its limit.  Exits non-zero, printing no
result, without a CUDA card, without the program, or if the JAX package or
JAX itself was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths (the
    # port builds its kernels into build/repro_torch/ itself)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "bench", sub)
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("bench: no src/repro_torch in this checkout", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

    import torch
    from bench.harness import cell

    spec = cell.benchmark()
    chips = next((w["chips"] for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"bench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA card(s); torch "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line = cell.run(args.workload, args.seed, args.seconds,
                    bool(args.trace), torch.device("cuda", 0), T_PROCESS,
                    bench=spec)
    found = cell.forbidden_modules()
    if found:
        print(f"bench: loaded {found}: the JAX package or JAX itself",
              file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
