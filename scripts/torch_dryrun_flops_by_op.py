"""The per-device FLOPs of one dry-run cell of the port, by DTensor op.

Traces the cell as ``python -m repro_torch.launch.dryrun`` does (meta
DTensors, a fake process group) and sums, for each DTensor op by its
operands' shapes and placements, the FLOPs one device runs and the op's
even share of its global FLOPs (global / devices).  An op whose ratio is
above 1 runs more than its share on each device: replicated over a mesh
dim, or computed whole where a split was possible.  The ops come out
largest first.  Plain ops inside `map_shards` bodies are not listed.

Usage:
  PYTHONPATH=src python scripts/torch_dryrun_flops_by_op.py ARCH SHAPE
      [--mesh pod|multipod] [--top 20]
"""
from __future__ import annotations

import argparse
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import cost


def by_op(arch: str, shape: str, multi_pod: bool) -> tuple:
    """(the cell's record, {(op, shapes, placements): [device FLOPs,
    global FLOPs, calls]})."""
    rows = defaultdict(lambda: [0.0, 0.0, 0])
    counted = cost.CostMode.__torch_dispatch__

    def dispatch(self, func, types, args=(), kwargs=None):
        if self.inner or not any(issubclass(t, DTensor) for t in types):
            return counted(self, func, types, args, kwargs)
        flops, total = self.c.flops, self.c.global_flops
        out = counted(self, func, types, args, kwargs)
        if self.c.flops > flops:
            row = rows[(str(func),
                        tuple(tuple(a.shape) for a in args
                              if isinstance(a, torch.Tensor)),
                        tuple(tuple(a.placements) for a in args
                              if isinstance(a, DTensor)))]
            row[0] += self.c.flops - flops
            row[1] += self.c.global_flops - total
            row[2] += 1
        return out

    cost.CostMode.__torch_dispatch__ = dispatch
    try:
        with dryrun.fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            rec = dryrun.analyze_cell(arch, shape, mesh)
    finally:
        cost.CostMode.__torch_dispatch__ = counted
    return rec, rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", choices=dryrun.ARCHS)
    ap.add_argument("shape")
    ap.add_argument("--mesh", choices=["pod", "multipod"], default="pod")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    rec, rows = by_op(args.arch, args.shape, args.mesh == "multipod")
    n = rec["chips"]
    print(f"{args.arch} × {args.shape} × {args.mesh}: "
          f"{rec['flops_per_device']:.4e} FLOPs per device, torch "
          f"{torch.__version__}")
    for (op, shapes, pls), (flops, total, calls) in sorted(
            rows.items(), key=lambda kv: -kv[1][0])[:args.top]:
        share = total / n
        ratio = flops / share if share else float("inf")
        print(f"  {flops:.4e} per device, {share:.4e} even share, "
              f"x{ratio:.2f}, {calls} calls: {op} {shapes} {pls}")


if __name__ == "__main__":
    main()
