"""The port's sharded programs computed for real: each case runs one smoke
arch in 4 or 8 gloo processes on a small CPU mesh, with the rules the
dry-run gives its cells (`repro_torch.launch.dryrun.cell_rules`), and
holds what the mesh computes against the same step run unsharded on the
same params and inputs.

What is held: the logits (``full_tensor()``), the prefill step's tokens,
the serve step's tokens and logits over a few decode steps, and the loss
and every gradient leaf of one train step.  The configs compute in fp32,
so that the only difference left is the order of each sum over a split
dim: every figure is within 1e-5 of the largest magnitude of its tensor.
The unsharded port is held against the JAX package in its own tests.

The cases cover the paths the sharded models take: grouped attention
with K/V expanded per query head (command-r: 2 kv heads over a model
axis of 4), attention per query block at global positions and the
prefill's last row under sequence parallelism (qwen2), the split-K decode
window (command-r), the mLSTM and sLSTM loops per shard in prefill and
the sLSTM step through DTensor in decode (xlstm), cross-attention to a
batch-sharded encoder K/V in decode (whisper), and the SSD scan per shard
with the partial gradients of its replicated inputs, the hybrid's
attention cache and the greedy token of a batch sharded on two mesh dims
on the (2, 2, 2) mesh (zamba2)."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 1e-5

_WORKER = """
import json, math, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import (batch_shardings, cell_config,
                                       cell_rules)
from repro_torch.models import get_model
from repro_torch.models.common import tree_map
from repro_torch.parallel.sharding import distribute
from repro_torch.train import (TrainHyper, make_grad_fn, make_prefill_step,
                               make_serve_step)
from repro_torch.train.optimizer import leaves

ARCH, KINDS, SEQ, BATCH, MESH, NAMES = json.loads(sys.argv[1])
store, out_path, rank = sys.argv[2], sys.argv[3], int(sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=math.prod(MESH))
mesh = init_device_mesh("cpu", tuple(MESH), mesh_dim_names=tuple(NAMES))
torch.manual_seed(0)
errs = {}


def err(name, got, want):
    got = got.full_tensor() if isinstance(got, DTensor) else got
    got, want = got.detach().double(), want.detach().double()
    scale = max(float(want.abs().max()), 1e-30)
    errs[name] = max(errs.get(name, 0.0),
                     float((got - want).abs().max()) / scale)


def setup(kind):
    cfg, shape = cell_config(ARCH, ShapeConfig(kind, kind, SEQ, BATCH),
                             get_smoke_config(ARCH))
    cfg = cfg.replace(compute_dtype="float32", param_dtype="float32")
    model = get_model(cfg)
    rules = cell_rules(cfg, shape, mesh, TrainHyper())
    params = model.init(0, device="cpu")
    return (model, rules, params,
            distribute(params, model.schema(), mesh, rules),
            batch_shardings(model.input_specs(shape), mesh, rules))


def inputs(vocab, shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, vocab, shape).astype(np.int32))


def place(batch, pl):
    return {k: distribute_tensor(v, mesh, pl[k], src_data_rank=None)
            for k, v in batch.items()}


with implicit_replication():
    if "prefill" in KINDS:
        model, rules, params, dparams, pl = setup("prefill")
        batch = {"tokens": inputs(model.cfg.vocab, (BATCH, SEQ), 1),
                 "labels": inputs(model.cfg.vocab, (BATCH, SEQ), 2)}
        dbatch = place(batch, pl)
        err("prefill_logits", model.forward(dparams, dbatch, rules),
            model.forward(params, batch))
        got = make_prefill_step(model, rules)(dparams, dbatch)
        want = make_prefill_step(model)(params, batch)
        errs["prefill_tokens_differ"] = int(
            (got.full_tensor() != want).sum())

    if "decode" in KINDS:
        model, rules, params, dparams, pl = setup("decode")
        cache = model.init_cache(BATCH, SEQ, device="cpu")
        if "cross" in cache:        # whisper: the encoder's K/V, random
            rng = np.random.RandomState(6)
            for t in cache["cross"].values():
                t.copy_(torch.from_numpy(rng.randn(*t.shape)))
        dcache = distribute(tree_map(torch.clone, cache),
                            model.cache_schema(BATCH, SEQ), mesh, rules)
        serve, dserve = make_serve_step(model), make_serve_step(model, rules)
        tokens = inputs(model.cfg.vocab, (BATCH, 1), 3)
        differ = 0
        for t in range(6):
            batch = {"tokens": tokens,
                     "pos": torch.full((BATCH,), t, dtype=torch.int32)}
            dbatch = place(batch, pl)
            logits, _ = model.decode_step(params, cache, batch)
            dlogits, _ = model.decode_step(dparams, dcache, dbatch, rules)
            err("decode_logits", dlogits, logits)
            # the serve step advances a copy of each cache once more
            got, _ = dserve(dparams, tree_map(torch.clone, dcache), dbatch)
            want, _ = serve(params, tree_map(torch.clone, cache), batch)
            differ += int((got.full_tensor() != want).sum())
            tokens = want[:, None]
        errs["decode_tokens_differ"] = differ

    if "train" in KINDS:
        model, rules, params, dparams, pl = setup("train")
        batch = {"tokens": inputs(model.cfg.vocab, (BATCH, SEQ), 4),
                 "labels": inputs(model.cfg.vocab, (BATCH, SEQ), 5)}
        loss, _, grads = make_grad_fn(model)(params, batch)
        dloss, _, dgrads = make_grad_fn(model, rules=rules)(
            dparams, place(batch, pl))
        err("train_loss", dloss, loss)
        for g, dg in zip(leaves(grads), leaves(dgrads)):
            err("train_grads", dg, g)

if rank == 0:
    with open(out_path, "w") as f:
        json.dump(errs, f)
dist.destroy_process_group()
"""


def _run(tmp_path, arg):
    world = 1
    for n in arg[4]:
        world *= n
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = tmp_path / "errs.json"
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_WORKER), json.dumps(arg),
         str(tmp_path / "store"), str(out), str(r)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            p.kill()
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch,kinds,seq,batch,mesh,names", [
    ("command-r-35b", ["prefill", "decode", "train"], 16, 4, (2, 4),
     ("data", "model")),
    ("qwen2-7b", ["prefill", "train"], 16, 4, (2, 2), ("data", "model")),
    ("xlstm-1.3b", ["prefill", "decode", "train"], 16, 4, (2, 2),
     ("data", "model")),
    ("whisper-medium", ["decode"], 16, 4, (2, 2), ("data", "model")),
    ("zamba2-1.2b", ["prefill", "decode", "train"], 16, 4, (2, 2, 2),
     ("pod", "data", "model")),
])
def test_sharded_step_equals_unsharded(tmp_path, arch, kinds, seq, batch,
                                       mesh, names):
    errs = _run(tmp_path, [arch, kinds, seq, batch, list(mesh), list(names)])
    print("ERRS", arch, errs)
    for kind in kinds:
        assert any(k.startswith(kind) for k in errs), (kind, errs)
    for name, e in errs.items():
        if name.endswith("_differ"):
            assert e == 0, (name, errs)
        else:
            assert e <= TOL, (name, errs)
