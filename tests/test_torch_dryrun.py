"""The port's dry-run (`repro_torch.launch.dryrun`), cost counter
(`repro_torch.roofline.cost`) and H100 roofline
(`repro_torch.roofline.report`) held against the JAX package's: the cells,
the per-cell configs and batch rules, the roofline formulas, a sharded
olmoe train and decode cell on a fake (2, 4) mesh, per-device FLOPs under
sharding, and one-device prefill FLOPs against JAX's HLO walk.  Fake
process groups live in subprocesses only."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JaxShape
from repro.launch import dryrun as JD
from repro.models import get_model as jax_get_model
from repro.roofline import report as JR
from repro.roofline.hlo_analysis import analyze
from repro.train import make_prefill_step as jax_prefill_step
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as TD
from repro_torch.models import get_model
from repro_torch.roofline import report as TR
from repro_torch.roofline.cost import count
from repro_torch.train import make_prefill_step

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _run(code: str, timeout=600) -> str:
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=timeout,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_cells_equal_reference():
    assert tconfigs.cells() == jconfigs.cells()
    for name in tconfigs.SHAPES:
        assert dataclasses.asdict(tconfigs.get_shape(name)) \
            == dataclasses.asdict(jconfigs.get_shape(name))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_cell_config_and_skip_equal_reference(arch):
    for shape in jconfigs.SHAPES:
        cfg, sh = TD.cell_config(arch, shape)
        jcfg, jsh = JD.cell_config(arch, shape)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(sh) == dataclasses.asdict(jsh)
        assert TD.skip_reason(cfg, shape) == JD.skip_reason(jcfg, shape)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_fit_batch_rule_equals_reference(arch, multi_pod):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    tmesh = SimpleNamespace(mesh_dim_names=names, shape=shape)
    jmesh = SimpleNamespace(axis_names=names, devices=np.empty(shape))
    from repro.parallel.sharding import make_rules as jax_rules
    from repro_torch.parallel.sharding import make_rules
    over = dict(tconfigs.get_config(arch).rules_overrides)
    for batch in (256, 128, 32, 8, 2, 1):
        assert TD.fit_batch_rule(tmesh, make_rules(tmesh, **over), batch) \
            == JD.fit_batch_rule(jmesh, jax_rules(jmesh, **over), batch)


def _record():
    return {"arch": "x", "shape": "train_4k", "kind": "train",
            "seq_len": 4096, "global_batch": 256, "chips": 256,
            "active_params": 360_000_000, "status": "ok",
            "flops_per_device": 3.6e14, "hlo_flops_per_device": 3.6e14,
            "bytes_per_device": 3.4e13, "hlo_bytes_per_device": 3.4e13,
            "collectives": [
                {"kind": "all-gather", "operand_bytes": 7200,
                 "group_size": 16, "span": 16, "count": 32},
                {"kind": "all-reduce", "operand_bytes": 1 << 20,
                 "group_size": 16, "span": 241, "count": 7},
                {"kind": "reduce-scatter", "operand_bytes": 1 << 24,
                 "group_size": 4, "span": 4, "count": 3},
                {"kind": "collective-permute", "operand_bytes": 64,
                 "group_size": 2, "span": 2, "count": 1}]}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_roofline_formulas_equal_reference(kind, monkeypatch):
    """The same record gives the JAX package's terms once the port's H100
    constants are swapped for its TPU ones (every link at its one ICI
    rate)."""
    monkeypatch.setattr(TR, "PEAK_FLOPS", JR.PEAK_FLOPS)
    monkeypatch.setattr(TR, "HBM_BW", JR.HBM_BW)
    monkeypatch.setattr(TR, "NVLINK_BW", JR.LINK_BW)
    monkeypatch.setattr(TR, "NET_BW", JR.LINK_BW)
    rec = dict(_record(), kind=kind)
    for o in rec["collectives"]:
        assert TR.wire_bytes(o["kind"], o["operand_bytes"],
                             o["group_size"]) \
            == JR.wire_bytes(o["kind"], o["operand_bytes"], o["group_size"])
    assert TR.model_flops(rec) == JR.model_flops(rec)
    assert TR.terms(rec) == JR.terms(rec)


def test_collectives_charge_the_slowest_link_crossed():
    rec = _record()
    t = TR.terms(rec)
    want = sum(TR.wire_bytes(o["kind"], o["operand_bytes"], o["group_size"])
               * o["count"] / (TR.NVLINK_BW if o["span"] <= 8
                               else TR.NET_BW)
               for o in rec["collectives"])
    assert t["collective_s"] == pytest.approx(want)
    # a 16-wide group spans two 8-GPU nodes: the network's rate
    assert TR.link_bw(rec["collectives"][0]) == TR.NET_BW == 50e9
    assert TR.link_bw(rec["collectives"][2]) == TR.NVLINK_BW == 450e9
    assert TR.PEAK_FLOPS == 989e12 and TR.HBM_BW == 3.35e12


def test_markdown_table_rows(tmp_path, monkeypatch):
    monkeypatch.setattr(TR, "ARTIFACT_DIR", tmp_path)
    (tmp_path / "a__train_4k__pod.json").write_text(json.dumps(_record()))
    (tmp_path / "b__long_500k__pod.json").write_text(json.dumps(
        {"arch": "b", "shape": "long_500k", "status": "skip",
         "reason": "full-attention arch"}))
    (tmp_path / "c__decode_32k__pod.json").write_text(json.dumps(
        {"arch": "c", "shape": "decode_32k", "status": "error",
         "error": "RuntimeError: aten.foo.default"}))
    lines = TR.markdown_table("pod").splitlines()
    assert len(lines) == 5
    assert "SKIP" in lines[3] and "aten.foo.default" in lines[4]
    assert "**memory**" in lines[2]


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-7b", "olmoe-1b-7b"])
def test_one_device_prefill_flops_match_hlo(arch):
    """One device, no mesh: the counted FLOPs of the prefill step are
    within 1 % of the JAX package's HLO walk of the same step."""
    shape = (64, 2)
    jcfg = jconfigs.get_smoke_config(arch).replace(
        attn_impl="xla", param_dtype="bfloat16")
    jm = jax_get_model(jcfg)
    compiled = jax.jit(jax_prefill_step(jm)).lower(
        jm.abstract_params(),
        jm.input_specs(JaxShape("p", "prefill", *shape))).compile()
    ref = analyze(compiled.as_text()).flops
    cfg = tconfigs.get_smoke_config(arch).replace(
        attn_impl="xla", param_dtype="bfloat16")
    model = get_model(cfg)
    _, ana = count(make_prefill_step(model), model.abstract_params(),
                   model.input_specs(ShapeConfig("p", "prefill", *shape)))
    assert ana.flops == pytest.approx(ref, rel=0.01)
    assert ana.global_flops == ana.flops and ana.collective_ops == []


def test_sharded_flops_count_per_device():
    """A matmul sharded 8 ways does 1/8 of its FLOPs on each device; a
    replicated one does all of them on each (the global shapes that a
    dispatch mode sees would count both whole)."""
    out = _run("""
        import torch, torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)
        from repro_torch.roofline.cost import count
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        x = torch.empty(256, 512, device="meta")
        w = torch.empty(512, 384, device="meta")
        _, one = count(torch.matmul, x, w)

        def put(t, pl):
            return distribute_tensor(t, mesh, pl, src_data_rank=None)
        _, sh = count(torch.matmul, put(x, [Shard(0), Shard(0)]),
                      put(w, [Replicate(), Replicate()]))
        _, rep = count(torch.matmul, put(x, [Replicate(), Replicate()]),
                       put(w, [Replicate(), Replicate()]))
        _, tp = count(torch.matmul, put(x, [Shard(0), Replicate()]),
                      put(w, [Replicate(), Shard(1)]))
        print(one.flops, sh.flops, rep.flops, tp.flops, sh.global_flops,
              len(sh.collective_ops))
    """)
    one, sh, rep, tp, glob, ncoll = map(float, out.split()[-6:])
    assert one == 2 * 256 * 512 * 384
    assert sh * 8 == one and tp * 8 == one
    assert rep == one and glob == one and ncoll == 0


def test_olmoe_cells_on_a_small_mesh():
    """The launcher machinery (rules, placements, batch fitting) on a fake
    (2, 4) mesh with the olmoe smoke config: the train and decode cells
    end ok and are genuinely sharded (they have collectives), as the JAX
    package's `test_small_mesh_train_and_serve_compile` asserts."""
    out = _run("""
        import json
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_smoke_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch.dryrun import analyze_cell, fake_world
        cfg = get_smoke_config("olmoe-1b-7b").replace(max_seq=32)
        with fake_world(8):
            mesh = init_device_mesh("cpu", (2, 4),
                                    mesh_dim_names=("data", "model"))
            for kind in ("train", "decode"):
                rec = analyze_cell("olmoe-1b-7b",
                                   ShapeConfig(kind, kind, 32, 4), mesh,
                                   cfg=cfg)
                print(json.dumps(rec))
    """)
    recs = [json.loads(line) for line in out.strip().splitlines()[-2:]]
    for rec in recs:
        assert rec["status"] == "ok" and rec["chips"] == 8
        assert rec["collectives"], "expected a sharded program"
        assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
        assert rec["counted_flops"] > rec["flops_per_device"]
        m = rec["memory"]
        assert m["argument_bytes"] > 0 and m["temp_bytes"] > 0
    train, decode = recs
    # the train step updates the state in place: the output is the input
    assert train["memory"]["alias_bytes"] > 0.9 * \
        train["memory"]["argument_bytes"]


def test_run_cell_on_the_multipod_mesh():
    """A production cell end to end on 512 fake ranks, and a skipped one
    that needs no process group."""
    out = _run("""
        import json
        from repro_torch.launch.dryrun import run_cell
        rec = run_cell("smollm-360m", "decode_32k", True, save=False,
                       verbose=False)
        skip = run_cell("smollm-360m", "long_500k", True, save=False,
                        verbose=False)
        print(json.dumps([rec, skip]))
    """)
    rec, skip = json.loads(out.strip().splitlines()[-1])
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 512 and rec["mesh"] == "multipod"
    assert {o["kind"] for o in rec["collectives"]} >= {"all-gather"}
    assert skip["status"] == "skip"
    assert skip["reason"] == JD.skip_reason(
        jconfigs.get_config("smollm-360m"), "long_500k")


def _specs(tree):
    """{path: (shape, dtype name)} of a tree of meta tensors or
    ShapeDtypeStructs (dicts, and the optimizer's NamedTuple)."""
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k in tree for p, v in _specs(tree[k]).items()}
    if isinstance(tree, tuple):
        return {f"{i}/{p}": v for i, t in enumerate(tree)
                for p, v in _specs(t).items()}
    return {"": (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_abstract_trees_equal_reference(arch):
    """`Model.input_specs`, `abstract_params`, `abstract_cache` and
    `abstract_state` give JAX's ShapeDtypeStructs' shapes and dtypes, as
    meta tensors."""
    from repro.train import abstract_state as jax_abstract_state
    from repro_torch.train import abstract_state

    cfg, jcfg = tconfigs.get_smoke_config(arch), \
        jconfigs.get_smoke_config(arch)
    model, jm = get_model(cfg), jax_get_model(jcfg)
    for name, shape in tconfigs.SHAPES.items():
        small = ShapeConfig(name, shape.kind, 16, 4)
        ours = model.input_specs(small)
        assert all(t.is_meta for t in ours.values())
        assert _specs(ours) == _specs(jm.input_specs(
            JaxShape(name, shape.kind, 16, 4)))
    assert _specs(model.abstract_params()) == _specs(jm.abstract_params())
    assert _specs(model.abstract_cache(4, 32)) \
        == _specs(jm.abstract_cache(4, 32))
    assert _specs(abstract_state(model)) == _specs(jax_abstract_state(jm))
