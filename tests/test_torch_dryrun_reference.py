"""The committed table of the JAX package's dry-run
(``scripts/jax_dryrun_reference.json``), which carries JAX's side of each
cell to a machine without JAX: it covers every cell of
`repro_torch.configs.cells` on both meshes, and
``scripts/torch_dryrun_vs_jax.py`` holds the port to it exactly as it
holds the port to the JAX artifacts it was written from."""
import json
import sys
from pathlib import Path

import pytest

from repro_torch import configs
from repro_torch.roofline import report

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import torch_dryrun_vs_jax as VS  # noqa: E402

TABLE = ROOT / "scripts" / "jax_dryrun_reference.json"


def test_table_covers_every_cell_on_both_meshes():
    table = VS.load_reference(TABLE)
    want = {(arch, shape, mesh): skip for arch, shape, skip
            in configs.cells() for mesh in ("pod", "multipod")}
    assert set(table) == set(want)
    for key, skip in want.items():
        row = table[key]
        assert row["status"] == ("skip" if skip else "ok"), row
        if skip:
            continue
        assert row["flops_per_device"] > 0 and row["bytes_per_device"] > 0
        assert row["collective_s"] >= 0
        assert row["bound"] in ("compute", "memory", "collective")
    assert sum(r["status"] == "ok" for r in table.values()) == 64


def _jax_record(arch, flops, coll_bytes):
    return {"arch": arch, "shape": "train_4k", "mesh": "pod",
            "status": "ok", "kind": "train", "seq_len": 4096,
            "global_batch": 256, "chips": 256, "active_params": 10 ** 9,
            "hlo_flops_per_device": flops, "hlo_bytes_per_device": 2e12,
            "collectives": [{"kind": "all-reduce",
                             "operand_bytes": coll_bytes,
                             "group_size": 16, "count": 10}]}


def _port_record(rec, flops, coll_bytes, views=0):
    out = dict(rec, flops_per_device=flops, bytes_per_device=3e12,
               torch_version="2.x", replicated={"aten.view.default": views}
               if views else {})
    out["collectives"] = [dict(rec["collectives"][0], span=16,
                               operand_bytes=coll_bytes)]
    del out["hlo_flops_per_device"], out["hlo_bytes_per_device"]
    return out


@pytest.mark.parametrize("flops,coll_bytes,views,misses", [
    (1.2e14, 1e9, 0, False),        # within both bounds
    (1.3e14, 1e9, 0, True),         # FLOPs over 1.25 ×
    (1.0e14, 3e9, 0, True),         # collective term over 2 ×
    (1.0e14, 1e9, 1, True),         # a view left to the counter
])
def test_reference_table_judges_as_the_artifacts(tmp_path, capsys, flops,
                                                 coll_bytes, views, misses):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "torch"
    jax_dir.mkdir()
    port_dir.mkdir()
    rec = _jax_record("qwen2-7b", 1e14, 1e9)
    (jax_dir / "qwen2-7b__train_4k__pod.json").write_text(json.dumps(rec))
    (port_dir / "qwen2-7b__train_4k__pod.json").write_text(json.dumps(
        _port_record(rec, flops, coll_bytes, views)))
    table = tmp_path / "ref.json"
    assert VS.main(["--jax", str(jax_dir), "--write-reference",
                    str(table)]) == 0
    row = VS.load_reference(table)[("qwen2-7b", "train_4k", "pod")]
    t = report.terms(dict(rec, flops_per_device=1e14,
                          bytes_per_device=2e12))
    assert row["collective_s"] == t["collective_s"]
    assert row["bound"] == t["bound"]
    capsys.readouterr()
    rcs, texts = [], []
    for side in (["--jax", str(jax_dir)], ["--reference", str(table)]):
        rcs.append(VS.main(side + ["--torch", str(port_dir), "--all"]))
        texts.append(capsys.readouterr().out)
    assert rcs == [int(misses)] * 2
    assert texts[0] == texts[1]
    assert "| 2.x |" in texts[0]
