"""The port's logical-axis sharding (`repro_torch.parallel.sharding`) and
production meshes held against the JAX package's: the rules table, the
rules made for each mesh, the PartitionSpec of every parameter of every
arch, and rank 0's shard shapes on a (2, 4) mesh against JAX's
`NamedSharding.shard_shape` on 8 host devices.  Process groups (a fake one
for the port, forced host devices for JAX) live in subprocesses only."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest
import torch

from repro.configs import ARCHS, get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.parallel import sharding as JS
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models.common import P
from repro_torch.parallel import sharding as TS

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESH_NAMES = [("data", "model"), ("pod", "data", "model")]


def _run(code: str, env_extra=None, timeout=600) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env.update(env_extra or {})
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=timeout,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _leaves(schema, is_p):
    if is_p(schema):
        return [schema]
    return [p for k in sorted(schema) for p in _leaves(schema[k], is_p)]


def test_default_rules_equal_reference():
    assert TS.DEFAULT_RULES == JS.DEFAULT_RULES


@pytest.mark.parametrize("names", MESH_NAMES + [("data", "model", "x")])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_rules_equal_reference(arch, names):
    over = dict(get_config(arch).rules_overrides)
    assert over == dict(jax_get_config(arch).rules_overrides)
    ours = TS.make_rules(SimpleNamespace(mesh_dim_names=names), **over)
    ref = JS.make_rules(SimpleNamespace(axis_names=names), **over)
    assert ours == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_every_leaf_equals_reference(arch):
    names = ("pod", "data", "model")
    over = dict(get_config(arch).rules_overrides)
    ours = _leaves(get_model(get_config(arch)).schema(),
                   lambda p: isinstance(p, P))
    ref = _leaves(jax_get_model(jax_get_config(arch)).schema(),
                  lambda p: isinstance(p, JS.P))
    assert [p.axes for p in ours] == [p.axes for p in ref]
    for rules_names in (names, ("data", "model")):
        t_rules = TS.make_rules(SimpleNamespace(mesh_dim_names=rules_names),
                                **over)
        j_rules = JS.make_rules(SimpleNamespace(axis_names=rules_names),
                                **over)
        for p, q in zip(ours, ref):
            assert TS.spec_for(p.axes, t_rules) \
                == tuple(JS.spec_for(q.axes, j_rules))


def test_placements_map_spec_to_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard

    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert TS.placements((("pod", "data"), None, "model"), mesh) \
        == (Shard(0), Shard(0), Shard(2))
    assert TS.placements((None, "data"), mesh) \
        == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        TS.placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="shards two dims"):
        TS.placements(("model", "model"), mesh)


def test_logical_constraint_is_identity_without_a_dtensor():
    x = torch.randn(2, 3, 4)
    rules = TS.make_rules(SimpleNamespace(mesh_dim_names=("data", "model")))
    assert TS.logical_constraint(x, ("batch", "seq", "act_embed"),
                                 None) is x
    assert TS.logical_constraint(x, ("batch", "seq", "act_embed"),
                                 rules) is x


def test_abstract_params_allocate_nothing():
    cfg = get_config("mistral-large-123b")
    params = get_model(cfg).abstract_params()
    leaves = _leaves(params, lambda t: isinstance(t, torch.Tensor))
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) == get_model(cfg).param_count()
    assert {t.dtype for t in leaves} == {torch.float32}


_SMOKES = ("qwen2-7b", "olmoe-1b-7b", "zamba2-1.2b")
_JAX_SHAPES = """
    import json, jax
    from jax.sharding import NamedSharding
    from repro.configs import get_smoke_config
    from repro.models import get_model
    from repro.parallel.sharding import make_rules, spec_for, P
    from repro.launch.mesh import _make_mesh
    mesh = _make_mesh(MESH_SHAPE, MESH_NAMES)
    out = {}
    for arch in ARCHES:
        cfg = get_smoke_config(arch)
        model = get_model(cfg)
        rules = make_rules(mesh, **dict(cfg.rules_overrides))
        for tree in ("params", "cache"):
            schema = model.schema() if tree == "params" \\
                else model.cache_schema(8, 16)
            leaves, _ = jax.tree_util.tree_flatten_with_path(
                schema, is_leaf=lambda x: isinstance(x, P))
            for path, p in leaves:
                key = arch + "/" + tree + jax.tree_util.keystr(path)
                sh = NamedSharding(mesh, spec_for(p.axes, rules))
                try:
                    out[key] = list(sh.shard_shape(p.shape))
                except ValueError:
                    out[key] = "uneven"
    print(json.dumps(out))
"""
_TORCH_SHAPES = """
    import json, torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.parallel.sharding import (abstract_params, distribute,
                                               make_rules)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    mesh = init_device_mesh("cpu", MESH_SHAPE, mesh_dim_names=MESH_NAMES)
    out = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], prefix + "[" + repr(k) + "]")
        else:
            out[prefix] = list(tree.to_local().shape)

    for arch in ARCHES:
        cfg = get_smoke_config(arch)
        model = get_model(cfg)
        rules = make_rules(mesh, **dict(cfg.rules_overrides))
        for tree in ("params", "cache"):
            schema = model.schema() if tree == "params" \\
                else model.cache_schema(8, 16)
            dt = cfg.param_dtype if tree == "params" else cfg.compute_dtype
            walk(distribute(abstract_params(schema, dt), schema, mesh,
                            rules), arch + "/" + tree)
    print(json.dumps(out))
"""


@pytest.mark.parametrize("mesh_shape,mesh_names", [
    ((2, 4), ("data", "model")),
    ((2, 2, 2), ("pod", "data", "model")),
])
def test_shard_shapes_equal_reference(mesh_shape, mesh_names):
    """Rank 0's local shape of every param and cache leaf equals JAX's
    shard shape.  JAX refuses a sharded dim that its mesh dims do not
    divide (DTensor splits it like ``torch.chunk``); those leaves, under a
    fifth of them, are left out."""
    header = (f"MESH_SHAPE = {mesh_shape}\nMESH_NAMES = {mesh_names}\n"
              f"ARCHES = {_SMOKES}\n")
    ref = json.loads(_run(header + textwrap.dedent(_JAX_SHAPES), {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "JAX_PLATFORMS": "cpu"}).strip().splitlines()[-1])
    ours = json.loads(_run(header + textwrap.dedent(_TORCH_SHAPES))
                      .strip().splitlines()[-1])
    assert set(ours) == set(ref) and len(ref) > 50
    even = {k for k, v in ref.items() if v != "uneven"}
    assert len(even) > 0.8 * len(ref)
    for k in even:
        assert ours[k] == ref[k], k


def test_rules_leave_a_one_rank_forward_unchanged(tmp_path):
    """On a (1, 1) mesh of one gloo rank, params and batch as DTensors and
    the rules at every constraint site give the logits of the plain
    forward: the sites redistribute, they do not compute."""
    out = _run(f"""
        import torch, torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import get_model
        from repro_torch.parallel.sharding import (distribute, make_rules,
                                                   placements, spec_for)
        dist.init_process_group("gloo", init_method="file://{tmp_path}/s",
                                rank=0, world_size=1)
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        for arch in ("smollm-360m", "olmoe-1b-7b", "zamba2-1.2b"):
            cfg = get_smoke_config(arch)
            model = get_model(cfg)
            rules = make_rules(mesh, **dict(cfg.rules_overrides))
            params = model.init(0, device="cpu")
            tokens = torch.randint(0, cfg.vocab, (2, 16),
                                   generator=torch.Generator().manual_seed(1))
            want = model.forward(params, {{"tokens": tokens}})
            d_tokens = distribute_tensor(
                tokens, mesh, placements(spec_for(("batch", None), rules),
                                         mesh))
            with implicit_replication():
                got = model.forward(distribute(params, model.schema(), mesh,
                                               rules),
                                    {{"tokens": d_tokens}}, rules)
            print(arch, float((got.full_tensor() - want).abs().max()))
        dist.destroy_process_group()
    """)
    errs = dict(line.split() for line in out.strip().splitlines()[-3:])
    assert set(errs) == {"smollm-360m", "olmoe-1b-7b", "zamba2-1.2b"}
    for arch, err in errs.items():
        assert float(err) <= 1e-6, (arch, err)


def test_trainer_takes_rules_and_with_hosts_drops_them(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import Cluster
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.train.trainer import Trainer

    cluster = Cluster(n_servers=2, data_dir=str(tmp_path), replication=1)
    try:
        fs = cluster.client()
        pipe = DataPipeline(fs, PipelineConfig(
            src_paths=("/none",), work_dir="/epochs", block_tokens=9,
            global_batch=2, seed=0))
        rules = TS.make_rules(SimpleNamespace(mesh_dim_names=("data",)))
        trainer = Trainer(get_model(get_smoke_config("smollm-360m")), pipe,
                          CheckpointManager(fs, "/ckpt"), rules=rules,
                          pod_sync=lambda tree: tree, device="cpu")
        assert trainer.rules is rules and trainer.pod_sync is not None
        moved = trainer.with_hosts(0, 1)
        assert moved.rules is None and moved.pod_sync is None
    finally:
        cluster.close()


def test_meshes():
    """The production meshes over 256 and 512 ranks (a fake process
    group), their refusal of any other world size, and a host mesh cut to
    the ranks that exist."""
    out = _run("""
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        import repro_torch.launch.mesh as M
        for world, multi in ((256, False), (512, True), (8, None)):
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=world)
            if multi is None:
                for m in (True, False):
                    try:
                        M.make_production_mesh(multi_pod=m,
                                               device_type="cpu")
                    except ValueError as e:
                        print("refused", world, str(e).split(";")[0])
                mesh = M.make_host_mesh(2, 8, device_type="cpu")
            else:
                mesh = M.make_production_mesh(multi_pod=multi,
                                              device_type="cpu")
            M.validate_mesh(mesh)
            print(world, M.mesh_devices(mesh), tuple(mesh.shape),
                  mesh.mesh_dim_names)
            dist.destroy_process_group()
    """)
    lines = out.strip().splitlines()
    assert "256 256 (16, 16) ('data', 'model')" in lines
    assert "512 512 (2, 16, 16) ('pod', 'data', 'model')" in lines
    assert sum(line.startswith("refused 8") for line in lines) == 2
    assert "8 8 (2, 4) ('data', 'model')" in lines
