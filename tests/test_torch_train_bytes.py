"""Each arch's train step, counted on its smoke config at two sequence
lengths S and 4S (batch 2), held against the JAX package's count of the
same step: the port's bytes (`repro_torch.roofline.cost.count` on
`make_train_step`, every eager op's operands) against JAX's
(`repro.roofline.hlo_analysis.analyze` on the compiled step, fusion
boundaries).  The two byte models differ by design, so the bytes are
held by how they grow: the port's bytes(4S) / bytes(S) at most
`GROWTH_BOUND` × JAX's, which an O(S²) backward in a Python loop over
the sequence fails (a slice or index per step whose backward writes a
zero gradient of the whole sequence).  At each length the port's bytes
are also at most `BYTES_BOUND` × JAX's, and its FLOPs within 1 % of
JAX's.

Run as a script it prints the table of both packages' counts:

  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train_bytes.py \\
      [ARCH ...] [--lengths 64 128 256 512]

With ``--cell`` it counts instead each arch's train_4k dry-run cell as
published on the (16, 16) mesh, its sequence length set to each of
``--lengths`` (both packages' dry-runs, one subprocess per count, all
started together), with the port's largest ops by bytes per device.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JaxShape
from repro.models import get_model as jax_get_model
from repro.roofline.hlo_analysis import analyze
from repro.train import abstract_state as jax_abstract_state
from repro.train import make_train_step as jax_train_step
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.mamba2_scan.ref import ssd_scan_plain
from repro_torch.models import get_model
from repro_torch.roofline.cost import count
from repro_torch.train import abstract_state, make_train_step

B = 2
LENGTHS = (64, 256)
# whisper's smoke config holds 64 decoder positions
ARCH_LENGTHS = {"whisper-medium": (16, 64)}
GROWTH_BOUND = 1.25
BYTES_BOUND = 1.25
FLOP_TOL = 0.01
SRC = str(Path(__file__).resolve().parents[1] / "src")

# the train_4k cell at another sequence length, through each package's
# dry-run: bytes and FLOPs per device (and the port's bytes by op)
_JAX_CELL = """
import json, sys
from repro.configs.base import ShapeConfig
from repro.launch import dryrun as JD
arch, s = sys.argv[1], int(sys.argv[2])
batch = JD.get_shape("train_4k").global_batch
JD.get_shape = lambda name: ShapeConfig(name, "train", s, batch)
rec = JD.run_cell(arch, "train_4k", False, save=False, verbose=False)
assert rec["status"] == "ok", rec
print(json.dumps({"bytes": rec["hlo_bytes_per_device"],
                  "flops": rec["hlo_flops_per_device"]}))
"""
_PORT_CELL = """
import json, sys
from repro_torch.configs import get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as TD
arch, s = sys.argv[1], int(sys.argv[2])
shape = ShapeConfig("train_4k", "train", s, get_shape("train_4k").global_batch)
rec = TD.run_cell(arch, shape, False, save=False, verbose=False)
assert rec["status"] == "ok", rec.get("error")
print(json.dumps({"bytes": rec["bytes_per_device"],
                  "flops": rec["flops_per_device"],
                  "by_op": rec["bytes_by_op"]}))
"""


def port_count(arch: str, s: int):
    model = get_model(tconfigs.get_smoke_config(arch))
    _, ana = count(make_train_step(model), abstract_state(model),
                   model.input_specs(ShapeConfig("t", "train", s, B)))
    return ana.flops, ana.bytes_accessed


def jax_count(arch: str, s: int):
    model = jax_get_model(jconfigs.get_smoke_config(arch))
    compiled = jax.jit(jax_train_step(model)).lower(
        jax_abstract_state(model),
        model.input_specs(JaxShape("t", "train", s, B))).compile(
            # LLVM's level changes the machine code, not the optimised
            # HLO that the walk reads; a quarter less compile time
            compiler_options={"xla_backend_optimization_level": 0})
    ana = analyze(compiled.as_text())
    return ana.flops, ana.bytes_accessed


def ssd_recompute_flops(arch: str, s: int) -> float:
    """The FLOPs the port's SSD op adds to a train step: its backward
    recomputes the scan's forward through the plain version (the kernel
    keeps no intermediates), one forward per Mamba2 layer, where the JAX
    package differentiates its scan as it ran.  0 for an arch without
    one."""
    cfg = tconfigs.get_smoke_config(arch)
    if cfg.ssm is None:
        return 0.0
    h = cfg.d_model * cfg.ssm.expand // cfg.ssm.head_dim
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    _, ana = count(lambda *t: ssd_scan_plain(*t, chunk=cfg.ssm.chunk),
                   meta(B, h, s, cfg.ssm.head_dim), meta(B, h, s),
                   meta(B, s, cfg.ssm.state_dim),
                   meta(B, s, cfg.ssm.state_dim))
    return cfg.n_layers * ana.flops


def counts(arch: str, s: int) -> dict:
    pf, pb = port_count(arch, s)
    jf, jb = jax_count(arch, s)
    return {"S": s, "port_flops": pf, "jax_flops": jf, "port_bytes": pb,
            "jax_bytes": jb, "ssd_flops": ssd_recompute_flops(arch, s)}


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_train_step_bytes_grow_no_faster_than_jax(arch):
    short, long_ = (counts(arch, s)
                    for s in ARCH_LENGTHS.get(arch, LENGTHS))
    port_growth = long_["port_bytes"] / short["port_bytes"]
    jax_growth = long_["jax_bytes"] / short["jax_bytes"]
    assert port_growth <= GROWTH_BOUND * jax_growth, (
        f"{arch}: bytes grow {port_growth:.3f}x from S={short['S']} to "
        f"{long_['S']} in the port, {jax_growth:.3f}x in JAX "
        f"({port_growth / jax_growth:.3f} of JAX's growth)")
    for c in (short, long_):
        assert c["port_flops"] - c["ssd_flops"] \
            == pytest.approx(c["jax_flops"], rel=FLOP_TOL), c
        assert c["port_bytes"] <= BYTES_BOUND * c["jax_bytes"], c


def cell_counts(archs, lengths) -> None:
    """Print both packages' bytes per device of each arch's train_4k cell
    on the (16, 16) mesh at each of ``lengths``."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    procs = {(arch, s, side): subprocess.Popen(
        [sys.executable, "-c", code, arch, str(s)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch in archs for s in lengths
        for side, code in (("jax", _JAX_CELL), ("port", _PORT_CELL))}
    got = {}
    for key, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{key} failed:\n{err[-3000:]}")
        got[key] = json.loads(out.strip().splitlines()[-1])
    print("| arch | S | port bytes/dev | JAX bytes/dev | port / JAX | "
          "port FLOP/dev / JAX's | the port's largest ops, bytes/dev |")
    print("|---|---|---|---|---|---|---|")
    for arch in archs:
        for s in lengths:
            p, j = got[(arch, s, "port")], got[(arch, s, "jax")]
            top = ", ".join(f"{op} {b:.3e}"
                            for op, b in list(p["by_op"].items())[:6])
            print(f"| {arch} | {s} | {p['bytes']:.4e} | {j['bytes']:.4e} | "
                  f"{p['bytes'] / j['bytes']:.3f} | "
                  f"{p['flops'] / j['flops']:.3f} | {top} |", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("archs", nargs="*", default=jconfigs.ARCHS)
    ap.add_argument("--lengths", type=int, nargs="+",
                    help="sequence lengths (default: the test's two)")
    ap.add_argument("--cell", action="store_true",
                    help="the train_4k cells on the (16, 16) mesh")
    args = ap.parse_args(argv)
    if args.cell:
        cell_counts(args.archs, args.lengths or (1024, 4096))
        return
    print("| arch | S | port FLOPs | JAX FLOPs | port FLOPs less the SSD "
          "recompute / JAX's | port bytes | JAX bytes | port / JAX bytes | "
          "growth port / JAX |")
    print("|---|---|---|---|---|---|---|---|---|")
    for arch in args.archs:
        first = None
        for s in args.lengths or ARCH_LENGTHS.get(arch, LENGTHS):
            c = counts(arch, s)
            first = first or c
            growth = (c["port_bytes"] / first["port_bytes"]) \
                / (c["jax_bytes"] / first["jax_bytes"])
            flops = (c["port_flops"] - c["ssd_flops"]) / c["jax_flops"]
            print(f"| {arch} | {s} | {c['port_flops']:.4e} | "
                  f"{c['jax_flops']:.4e} | {flops:.4f} | "
                  f"{c['port_bytes']:.4e} | "
                  f"{c['jax_bytes']:.4e} | "
                  f"{c['port_bytes'] / c['jax_bytes']:.2f} | "
                  f"{growth:.2f} |", flush=True)


if __name__ == "__main__":
    main()
