"""Three-term roofline from the dry-run artifacts, for the NVIDIA H100
(the port of the JAX package's ``roofline/report.py``, whose hardware
model is a TPU's; none of its constants is kept).

Hardware model (per GPU, H100 SXM5):
  peak bf16 compute : 989e12 FLOP/s dense (H100 SXM5 datasheet)
  HBM3 bandwidth    : 3.35e12 B/s (H100 SXM5 datasheet)
  NVLink 4          : 450e9 B/s per direction (900 GB/s total, datasheet)
  between nodes     : 50e9 B/s (one 400 Gb/s NDR InfiniBand NIC per GPU,
                      DGX H100 reference architecture)
  GPUs per node     : 8 on one NVLink switch fabric (DGX H100)

Terms (seconds per step, per GPU — the counts are already per device):
  compute    = flops_per_device / 989e12
  memory     = bytes_per_device / 3.35e12
  collective = Σ_ops ring_wire_bytes(kind, operand_bytes, group) / link_bw
Each collective is charged at the bandwidth of the slowest link its group
crosses: ranks are laid out in mesh order, 8 to a node, so a group whose
ranks span more than one node (a 16-wide model group already does) runs
at the network's rate, and one inside a node at NVLink's.

Ring wire bytes per GPU: all-reduce 2·B·(g−1)/g, all-gather/
reduce-scatter/all-to-all B·(g−1)/g, collective-permute B.

MODEL_FLOPS = 6·N_active·D (train), 2·N_active·D (prefill/decode forward
only); its ratio to the counted FLOPs exposes remat/recompute and
quadratic-attention work that 6·N·D does not model.

Run ``python -m repro_torch.roofline.report [--mesh pod|multipod]``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

PEAK_FLOPS = 989e12         # dense bf16 FLOP/s, H100 SXM5 datasheet
HBM_BW = 3.35e12            # HBM3 B/s, H100 SXM5 datasheet
NVLINK_BW = 450e9           # NVLink 4 B/s per direction (900 GB/s total)
NET_BW = 50e9               # 400 Gb/s NDR NIC per GPU (DGX H100)
GPUS_PER_NODE = 8           # DGX H100

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" \
    / "dryrun_torch"

# A sharded cell of the port against the JAX package's count of the same
# cell (its HLO walk, collectives under the same link rule): at most
# FLOP_BOUND × its FLOPs per device, and a collective term at most
# COLL_BOUND × its own or under COLL_FLOOR_S.
FLOP_BOUND = 1.25
COLL_BOUND = 2.0
COLL_FLOOR_S = 0.010


def within_reference(flops: float, coll_s: float, ref_flops: float,
                     ref_coll_s: float) -> Tuple[bool, bool]:
    """(FLOPs within bound, collective term within bound) of a port cell
    against the reference's numbers for it."""
    return (flops <= FLOP_BOUND * ref_flops,
            coll_s <= COLL_BOUND * ref_coll_s or coll_s < COLL_FLOOR_S)


def wire_bytes(kind: str, operand_bytes: float, group: int) -> float:
    g = max(group, 1)
    frac = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * operand_bytes * frac
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return operand_bytes * frac
    if kind == "collective-permute":
        return float(operand_bytes)
    return float(operand_bytes)


def link_bw(op: dict) -> float:
    """The slowest link a collective's group crosses: ``span`` is the
    distance from its first rank to its last, plus one."""
    span = op.get("span", op["group_size"])
    return NVLINK_BW if span <= GPUS_PER_NODE else NET_BW


def model_flops(rec: dict) -> float:
    n = rec["active_params"]
    tokens = rec["global_batch"] * (rec["seq_len"]
                                    if rec["kind"] != "decode" else 1)
    mult = 6 if rec["kind"] == "train" else 2
    return float(mult * n * tokens)


def terms(rec: dict) -> Dict[str, float]:
    t = {
        "compute_s": rec["flops_per_device"] / PEAK_FLOPS,
        "memory_s": rec["bytes_per_device"] / HBM_BW,
        "collective_s": sum(
            wire_bytes(o["kind"], o["operand_bytes"], o["group_size"])
            * o["count"] / link_bw(o) for o in rec["collectives"]),
    }
    t["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                        key=lambda k: t[k])
    t["bound"] = t["dominant"].split("_")[0]
    mf = model_flops(rec)
    t["model_flops"] = mf
    t["flops_ratio"] = mf / max(1.0, rec["flops_per_device"]
                                * rec["chips"])
    # roofline fraction: useful model flops per second at the bottleneck
    step_time = t[t["dominant"]]
    t["step_s"] = step_time
    t["mfu"] = mf / (rec["chips"] * PEAK_FLOPS * step_time) \
        if step_time > 0 else 0.0
    return t


def load(mesh: str = "pod") -> List[dict]:
    return [json.loads(p.read_text())
            for p in sorted(ARTIFACT_DIR.glob(f"*__{mesh}.json"))]


MOVE_HINTS = {
    ("compute", "train"): "cast more matmuls to bf16 / shard attention "
                          "heads (TP) where divisibility allows",
    ("compute", "prefill"): "flash-attention kernel halves masked-block "
                            "work; shard sequence (SP) across model axis",
    ("compute", "decode"): "batch more sequences per GPU; fold GQA "
                           "groups into one matmul pane",
    ("memory", "train"): "raise accum_steps (microbatching) and remat to "
                         "shrink live activations; fuse elementwise "
                         "chains (eager runs each op through HBM)",
    ("memory", "prefill"): "fuse attention (flash) to avoid S² logits in "
                           "HBM",
    ("memory", "decode"): "decode is KV-bandwidth bound by nature: "
                          "shrink cache via windowing/quantization, or "
                          "raise batch to amortize weight reads",
    ("collective", "train"): "overlap grad all-reduce with backward; "
                             "int8-compress cross-node gradients",
    ("collective", "prefill"): "keep TP groups inside one NVLink node; "
                               "batch the per-layer all-gathers",
    ("collective", "decode"): "keep params resident (no per-step "
                              "all-gather); shrink TP to one NVLink node",
}


def row(rec: dict) -> Optional[dict]:
    if rec["status"] == "skip":
        return {"arch": rec["arch"], "shape": rec["shape"],
                "skip": rec["reason"]}
    if rec["status"] != "ok":
        return {"arch": rec["arch"], "shape": rec["shape"],
                "skip": f"ERROR {rec.get('error', '?')[:80]}"}
    t = terms(rec)
    hint = MOVE_HINTS.get((t["bound"], rec["kind"]), "")
    return {"arch": rec["arch"], "shape": rec["shape"],
            "kind": rec["kind"], "chips": rec["chips"], **t,
            "flops_dev": rec["flops_per_device"],
            "bytes_dev": rec["bytes_per_device"],
            "hint": hint}


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}µs"


def markdown_table(mesh: str = "pod", records: Optional[List[dict]] = None,
                   extra: Optional[Tuple[str, Callable]] = None) -> str:
    """The roofline table of ``mesh``'s artifacts (or of ``records``);
    ``extra`` = (header, fn(record) -> str) adds a last column."""
    head, fn = extra or (None, None)
    lines = [
        "| arch | shape | compute | memory | collective | bound | "
        "MODEL_FLOPS | MF/counted | what moves the dominant term |"
        + (f" {head} |" if head else ""),
        "|---|---|---|---|---|---|---|---|---|" + ("---|" if head else ""),
    ]
    for rec in load(mesh) if records is None else records:
        r = row(rec)
        if r is None:
            continue
        more = f" {fn(rec)} |" if fn else ""
        if "skip" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"SKIP | — | — | {r['skip'][:70]} |" + more)
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(r['compute_s'])} | "
            f"{_fmt_s(r['memory_s'])} | {_fmt_s(r['collective_s'])} | "
            f"**{r['bound']}** | {r['model_flops']:.2e} | "
            f"{r['flops_ratio']:.3f} | {r['hint']} |" + more)
    return "\n".join(lines)


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    args = ap.parse_args()
    print(markdown_table(args.mesh))


if __name__ == "__main__":
    main()
