"""The port's dry-run held against the JAX package's, cell by cell.

Reads the JAX package's artifacts (``artifacts/dryrun/``, made by
``PYTHONPATH=src python -m repro.launch.dryrun --all --mesh both``) and
the port's (``artifacts/dryrun_torch/``, made by ``PYTHONPATH=src python
-m repro_torch.launch.dryrun --all --mesh both``) and prints, for every
cell both count ``ok``: FLOPs per device of each and their ratio, each
collective term under the port's H100 model
(`repro_torch.roofline.report.terms`, one link rule for both; JAX's
collectives carry no ``span`` and are charged by their group size), the
ops the port's counter had to replicate, the bound of each, and the port
/ JAX bytes per device.  No bound applies to the bytes: the port charges
every eager op's operands, JAX only its fusions' (held instead by how
they grow with the sequence, in ``tests/test_torch_train_bytes.py``).

A cell misses when the port counts more than ``FLOP_BOUND`` × JAX's FLOPs
per device, or when its collective term is both over ``COLL_BOUND`` × JAX's
and over ``COLL_FLOOR_S`` (the bounds of `repro_torch.roofline.report`);
such numbers are marked with ``!``.  The exit code is 1 when a cell
misses.

JAX's side can also travel as data, for a machine without JAX:
``--write-reference FILE`` writes, from the JAX artifacts, one entry per
cell with its status and JAX's FLOPs and bytes per device, collective
term and dominant term (``scripts/jax_dryrun_reference.json`` is the
committed one, which ``chip_smoke.py``'s dryrun phase reads too), and
``--reference FILE`` reads such a table in place of ``--jax DIR``.

Usage:
  PYTHONPATH=src python scripts/torch_dryrun_vs_jax.py [--jax DIR |
      --reference FILE] [--torch DIR] [--all | --beside DIR | --roofline]
  PYTHONPATH=src python scripts/torch_dryrun_vs_jax.py --write-reference
      scripts/jax_dryrun_reference.json [--jax DIR]
``--all`` also lists the cells within both bounds (by default only the
cells that miss are listed, then a summary), each with the torch version
that counted it.  ``--beside DIR`` prints instead the port / JAX FLOPs
and bytes per device and collective term and the trace seconds of each
cell beside those of the port's artifacts in DIR (another torch
version's run).
``--roofline`` prints instead the port's H100 roofline table of each mesh
(`repro_torch.roofline.report.markdown_table`) with a last column for
the port / JAX FLOPs and bytes per device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.roofline.report import (COLL_BOUND, COLL_FLOOR_S,
                                        FLOP_BOUND, markdown_table, terms,
                                        within_reference)

ROOT = Path(__file__).resolve().parents[1]

DENSE = ("smollm-360m", "qwen2-7b", "command-r-35b", "mistral-large-123b",
         "llava-next-34b")


def reference(rec: dict) -> dict:
    """One JAX artifact as a reference entry: its status and, where ``ok``,
    FLOPs and bytes per device, collective term and dominant term under
    the port's H100 model (JAX's collectives carry no ``span`` and are
    charged by their group size)."""
    out = {k: rec[k] for k in ("arch", "shape", "mesh", "status")}
    if rec["status"] == "ok":
        t = terms(dict(rec, flops_per_device=rec["hlo_flops_per_device"],
                       bytes_per_device=rec["hlo_bytes_per_device"]))
        out.update(flops_per_device=rec["hlo_flops_per_device"],
                   bytes_per_device=rec["hlo_bytes_per_device"],
                   collective_s=t["collective_s"], bound=t["bound"])
    return out


def load(directory: Path) -> dict:
    recs = {}
    for p in sorted(directory.glob("*__*__*.json")):
        rec = json.loads(p.read_text())
        recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    return recs


def load_reference(path: Path) -> dict:
    """A table that `--write-reference` wrote, keyed as `load`'s."""
    return {(r["arch"], r["shape"], r["mesh"]): r
            for r in json.loads(path.read_text())["cells"]}


def write_reference(jaxes: dict, path: Path) -> None:
    cells = [reference(jaxes[k]) for k in sorted(jaxes)]
    path.write_text(json.dumps({
        "source": "python -m repro.launch.dryrun --all --mesh both "
                  "(the JAX package's dry-run: HLO walk of each compiled "
                  "cell on forced host devices), then "
                  "scripts/torch_dryrun_vs_jax.py --write-reference",
        "cells": cells}, indent=1) + "\n")


def compare(port: dict, ref: dict) -> dict:
    """One cell: the numbers of the table and whether each bound holds."""
    tp = terms(port)
    ratio = port["flops_per_device"] / max(ref["flops_per_device"], 1.0)
    flops_ok, coll_ok = within_reference(
        port["flops_per_device"], tp["collective_s"],
        ref["flops_per_device"], ref["collective_s"])
    views = port.get("replicated", {}).get("aten.view.default", 0)
    return {"port_flops": port["flops_per_device"],
            "jax_flops": ref["flops_per_device"], "ratio": ratio,
            "bytes_ratio": port["bytes_per_device"]
            / max(ref["bytes_per_device"], 1.0),
            "port_coll_s": tp["collective_s"],
            "jax_coll_s": ref["collective_s"],
            "views": views, "replicated": port.get("replicated", {}),
            "port_bound": tp["bound"], "jax_bound": ref["bound"],
            "flops_ok": flops_ok, "coll_ok": coll_ok,
            "views_ok": views == 0 or port["arch"] not in DENSE}


def table(ports: dict, jaxes: dict, everything: bool) -> tuple:
    rows = ["| arch | shape | mesh | port FLOP/dev | JAX FLOP/dev | "
            "port / JAX | port coll s | JAX coll s | replicated | "
            "bound port / JAX | bytes/dev port / JAX | torch |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    misses, both = [], 0
    for key in sorted(set(ports) & set(jaxes)):
        port, jax = ports[key], jaxes[key]
        if port["status"] != "ok" or jax["status"] != "ok":
            continue
        both += 1
        c = compare(port, jax)
        ok = c["flops_ok"] and c["coll_ok"] and c["views_ok"]
        if not ok:
            misses.append(key)
        if ok and not everything:
            continue
        rep = ", ".join(f"{k.replace('aten.', '').replace('.default', '')}"
                        f" {n}" for k, n in sorted(c["replicated"].items()))
        rows.append(
            f"| {key[0]} | {key[1]} | {key[2]} | {c['port_flops']:.4e} | "
            f"{c['jax_flops']:.4e} | {c['ratio']:.2f}"
            f"{'' if c['flops_ok'] else ' !'} | {c['port_coll_s']:.4g}"
            f"{'' if c['coll_ok'] else ' !'} | {c['jax_coll_s']:.4g} | "
            f"{rep or '—'}{'' if c['views_ok'] else ' !'} | "
            f"{c['port_bound']} / {c['jax_bound']} | "
            f"{c['bytes_ratio']:.2f} | "
            f"{port.get('torch_version', '?')} |")
    return "\n".join(rows), misses, both


def beside(ports: dict, others: dict, jaxes: dict) -> str:
    """Each cell ``ok`` in both runs of the port and in JAX's: FLOPs and
    bytes per device and the collective term over JAX's, and the trace
    seconds, of ``ports`` beside ``others`` (two torch versions, say)."""
    def version(recs):
        return ", ".join(sorted({r.get("torch_version", "?")
                                 for r in recs.values()
                                 if r["status"] == "ok"}))
    rows = [f"A: torch {version(ports)}; B: torch {version(others)}", "",
            "| arch | shape | mesh | FLOP/dev port / JAX, A; B | "
            "bytes/dev port / JAX, A; B | coll s port / JAX, A; B | "
            "trace s, A; B |",
            "|---|---|---|---|---|---|---|"]
    for key in sorted(set(ports) & set(others) & set(jaxes)):
        recs = (ports[key], others[key])
        ref = jaxes[key]
        if ref["status"] != "ok" or any(r["status"] != "ok" for r in recs):
            continue
        flops, nbytes = ("; ".join(f"{r[k] / ref[k]:.4f}" for r in recs)
                         for k in ("flops_per_device", "bytes_per_device"))
        coll = "; ".join(
            f"{terms(r)['collective_s'] / ref['collective_s']:.2f}"
            for r in recs)
        trace = "; ".join(f"{r['trace_s']:g}" for r in recs)
        rows.append(f"| {key[0]} | {key[1]} | {key[2]} | {flops} | "
                    f"{nbytes} | {coll} | {trace} |")
    return "\n".join(rows)


def roofline(ports: dict, jaxes: dict) -> str:
    """The port's roofline table of each mesh, with the port / JAX FLOPs
    and bytes per device where JAX counts the cell ``ok``."""
    def ratio(rec):
        jax = jaxes.get((rec["arch"], rec["shape"], rec["mesh"]), {})
        if rec["status"] != "ok" or jax.get("status") != "ok":
            return "—"
        flops = rec["flops_per_device"] / jax["flops_per_device"]
        nbytes = rec["bytes_per_device"] / jax["bytes_per_device"]
        return f"{flops:.2f}, {nbytes:.2f}"
    out = []
    for mesh in ("pod", "multipod"):
        recs = [r for k, r in sorted(ports.items()) if k[2] == mesh]
        out += [f"{mesh}:", markdown_table(
            records=recs, extra=("port / JAX FLOP, bytes", ratio))]
    return "\n\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax", type=Path, default=ROOT / "artifacts" / "dryrun")
    ap.add_argument("--reference", type=Path,
                    help="JAX's side from this table, not from --jax")
    ap.add_argument("--write-reference", type=Path,
                    help="write the table of --jax's artifacts here, "
                         "then exit")
    ap.add_argument("--torch", type=Path,
                    default=ROOT / "artifacts" / "dryrun_torch")
    ap.add_argument("--all", action="store_true",
                    help="list every cell, not only those that miss")
    ap.add_argument("--beside", type=Path,
                    help="print the port's ratios to JAX's beside those of "
                         "the port's artifacts in this directory")
    ap.add_argument("--roofline", action="store_true",
                    help="print the port's roofline table of both meshes")
    args = ap.parse_args(argv)
    if args.write_reference:
        jaxes = load(args.jax)
        if not jaxes:
            print(f"no artifacts in {args.jax}", file=sys.stderr)
            return 2
        write_reference(jaxes, args.write_reference)
        print(f"{len(jaxes)} cells written to {args.write_reference}")
        return 0
    ports = load(args.torch)
    jaxes = load_reference(args.reference) if args.reference else {
        k: reference(r) for k, r in load(args.jax).items()}
    if not ports or not jaxes:
        print(f"no artifacts in {args.torch if not ports else args.jax}",
              file=sys.stderr)
        return 2
    if args.roofline:
        print(roofline(ports, jaxes))
        return 0
    if args.beside:
        print(beside(ports, load(args.beside), jaxes))
        return 0
    text, misses, both = table(ports, jaxes, args.all)
    print(text)
    print(f"\n{both} cells ok in both; {len(misses)} over a bound "
          f"(FLOPs/dev > {FLOP_BOUND}× JAX's, collective term > "
          f"{COLL_BOUND}× JAX's and ≥ {COLL_FLOOR_S * 1e3:.0f} ms, or a "
          f"replicated view in a dense/vlm cell)"
          + (": " + ", ".join("×".join(k) for k in misses) if misses
             else ""))
    return 1 if misses else 0


if __name__ == "__main__":
    raise SystemExit(main())
