"""The per-device FLOPs of one dry-run cell of the port, by DTensor op.

Traces the cell as ``python -m repro_torch.launch.dryrun`` does (meta
DTensors, a fake process group) and sums, for each DTensor op by its
operands' shapes and placements, the FLOPs one device runs and the op's
even share of its global FLOPs (global / devices).  An op whose ratio is
above 1 runs more than its share on each device: replicated over a mesh
dim, or computed whole where a split was possible.  The ops come out
largest first.  Plain ops inside `map_shards` bodies are not listed.

`op_rows` and `ratios` serve other traces too (a smoke cell on a small
fake mesh, in ``tests/test_torch_dryrun_moe.py``).

Usage:
  PYTHONPATH=src python scripts/torch_dryrun_flops_by_op.py ARCH SHAPE
      [--mesh pod|multipod] [--top 20]
"""
from __future__ import annotations

import argparse
import contextlib
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import cost


@contextlib.contextmanager
def op_rows():
    """Within the block, the cost counter also sums each DTensor op's
    FLOPs into the yielded {(op, shapes, placements): [device FLOPs,
    global FLOPs, calls]}."""
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
        yield rows
    finally:
        cost.CostMode.__torch_dispatch__ = counted


def ratios(rows: dict, devices: int) -> list:
    """(op, shapes, placements, device FLOPs, even share, ratio, calls) of
    each row, largest first: the ratio is above 1 where each device runs
    more than its even share (global FLOPs / devices)."""
    out = []
    for (op, shapes, pls), (flops, total, calls) in rows.items():
        share = total / devices
        out.append((op, shapes, pls, flops, share,
                    flops / share if share else float("inf"), calls))
    return sorted(out, key=lambda r: -r[3])


def by_op(arch: str, shape: str, multi_pod: bool) -> tuple:
    """(the cell's record, `op_rows`'s rows of its trace)."""
    with op_rows() as rows, dryrun.fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rec = dryrun.analyze_cell(arch, shape, mesh)
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
    for op, shapes, pls, flops, share, ratio, calls in \
            ratios(rows, n)[:args.top]:
        print(f"  {flops:.4e} per device, {share:.4e} even share, "
              f"x{ratio:.2f}, {calls} calls: {op} {shapes} {pls}")


if __name__ == "__main__":
    main()
