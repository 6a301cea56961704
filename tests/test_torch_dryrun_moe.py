"""The port's sharded MoE dry-run cells held against the JAX package's on
small fake meshes, as ``tests/test_torch_dryrun_sharded.py`` holds the
other families (the same runners and bounds, in a file of its own so that
its cells run on a worker of their own): olmoe-1b-7b's train step on
(2, 4) and (2, 2, 2), and granite-moe-3b-a800m's sequence-parallel
prefill on (2, 4).  Each must count at most 1.25 × JAX's FLOPs per device
and leave no view to the counter.

Two more cases trace the production olmoe-1b-7b × train_4k cell on the
(16, 16) and (2, 16, 16) meshes by DTensor op
(``scripts/torch_dryrun_flops_by_op.py``): no batched product may run
more than its even share on a device, and the cell must count at most
1.25 × the FLOPs per device of JAX's table
(``scripts/jax_dryrun_reference.json``).  Left to DTensor's strategies,
the expert products' backward ran whole on every rank of the batch axes
in some torch versions (16 and 32 × its share), and in others each pod
computed the whole capacity (2 ×); the block now runs them per shard
(`repro_torch.models.layers._expert_ffn`)."""
import json
from pathlib import Path

import pytest

from repro_torch.roofline.report import FLOP_BOUND
from test_torch_dryrun_sharded import _JAX, _TORCH, FLAT, PODS, _run

ROOT = Path(__file__).resolve().parents[1]

_BY_OP = f"""
import json, sys
sys.path.insert(0, {str(ROOT / "scripts")!r})
from torch_dryrun_flops_by_op import by_op, ratios
rec, rows = by_op("olmoe-1b-7b", "train_4k", json.loads(sys.argv[1]))
print(json.dumps({{"flops_per_device": rec["flops_per_device"],
                  "bmm": [[op, str(shapes), str(pls), ratio]
                          for op, shapes, pls, _, _, ratio, _
                          in ratios(rows, rec["chips"]) if "bmm" in op]}}))
"""


@pytest.mark.parametrize("arch,kind,seq,batch,mesh", [
    ("olmoe-1b-7b", "train", 64, 8, FLAT),
    ("olmoe-1b-7b", "train", 64, 8, PODS),
    ("granite-moe-3b-a800m", "prefill", 64, 4, FLAT),
])
def test_moe_flops_per_device_within_the_reference_share(arch, kind, seq,
                                                         batch, mesh):
    arg = [arch, kind, seq, batch, list(mesh[0]), list(mesh[1])]
    ref = json.loads(_run(_JAX, arg, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "JAX_PLATFORMS": "cpu"}))
    ours = json.loads(_run(_TORCH, arg))
    assert ours["collectives"], "expected a sharded program"
    ratio = ours["flops_per_device"] / ref
    assert ratio <= FLOP_BOUND, (ratio, ours["replicated"])
    assert "aten.view.default" not in ours["replicated"], ours["replicated"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_olmoe_train_cell_runs_no_batched_product_over_its_share(multi_pod):
    out = json.loads(_run(_BY_OP, multi_pod))
    over = [row for row in out["bmm"] if row[3] > 1.0 + 1e-9]
    assert not over, over
    table = json.loads((ROOT / "scripts" / "jax_dryrun_reference.json")
                       .read_text())
    mesh = "multipod" if multi_pod else "pod"
    ref = next(r for r in table["cells"] if (r["arch"], r["shape"],
                                             r["mesh"])
               == ("olmoe-1b-7b", "train_4k", mesh))
    assert out["flops_per_device"] <= FLOP_BOUND * ref["flops_per_device"]
