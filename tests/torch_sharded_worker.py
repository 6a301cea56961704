"""One case of the port's sharded programs computed for real, in gloo
processes on a small CPU mesh: the worker that
`tests/test_torch_sharded_values.py`, `tests/test_torch_sharded_train.py`,
`tests/test_torch_sharded_train_jax.py` and ``chip_smoke.py
sharded_train`` start, one process per rank, through `run`.

A case is a dict:

  arch, kinds, seq, batch, mesh, names   the smoke arch, the step kinds
      ("prefill", "decode", "train"), the global shape, the mesh's dim
      sizes and names;
  accum     the train step's microbatches (default 1), given to both
      `cell_rules` and `make_grad_fn`;
  params    an ``.npz`` of the train params (flattened paths, '/'
      between keys) to start from, in place of ``model.init(0)``;
  dump      an ``.npz`` that rank 0 writes the sharded train step's loss
      and gradients to (the same paths; the loss under "loss").

Each rank builds the cell's rules with the dry-run's `cell_rules`, places
the params and inputs by them, and holds what the mesh computes against
the same step run unsharded on the same params and inputs: the logits
(``full_tensor()``), the prefill step's tokens, the serve step's tokens
and logits over a few decode steps, and the loss and every gradient leaf
of one train step.  The configs compute in fp32, so each error is taken
relative to the largest magnitude of its tensor.  Rank 0 writes the
errors as JSON, with "*_differ" counts of tokens that differ and, for an
MoE arch, "min_margin": the smallest gap between the k-th and (k+1)-th
router probability met in the unsharded steps (a choice at a near-tie may
flip between two runs of the same function)."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 1e-5


def run(case: dict, workdir, timeout: float = 400) -> dict:
    """Run ``case`` in one process per rank (files under ``workdir``) and
    return rank 0's errors; raises with a rank's stderr if one fails."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    out = workdir / "errs.json"
    for stale in (out, workdir / "store"):       # a file store is one-shot
        stale.unlink(missing_ok=True)
    logs = [workdir / f"rank{r}.err" for r in range(math.prod(case["mesh"]))]
    procs = []
    try:
        for r, log in enumerate(logs):
            # stderr to a file: a rank blocked on a full pipe would stall
            # the collectives of every other
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, json.dumps(case),
                     str(workdir / "store"), str(out), str(r)], env=env,
                    stdout=subprocess.DEVNULL, stderr=f))
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    errs = [log.read_text() for log in logs]
    # a rank whose peer failed fails too; its own error comes first
    failed = sorted((r for r, p in enumerate(procs) if p.returncode),
                    key=lambda r: "by peer" in errs[r])
    if failed:
        raise RuntimeError(f"ranks {failed} failed; rank {failed[0]}:\n"
                           f"{errs[failed[0]][-3000:]}")
    return json.loads(out.read_text())


def check(errs: dict, kinds) -> None:
    """Every kind ran, no token differs and every error is within
    `TOL`."""
    for kind in kinds:
        assert any(k.startswith(kind) for k in errs), (kind, errs)
    for name, e in errs.items():
        if name.endswith("_differ"):
            assert e == 0, (name, errs)
        elif name != "min_margin":
            assert e <= TOL, (name, errs)


def flat_paths(tree, prefix=""):
    """{"a/b": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def nest(flat: dict) -> dict:
    """`flat_paths` undone."""
    tree = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _worker(case, store, out_path, rank):
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import (batch_shardings, cell_config,
                                           cell_rules)
    from repro_torch.models import get_model, layers
    from repro_torch.models.common import tree_map
    from repro_torch.parallel.sharding import distribute
    from repro_torch.train import (TrainHyper, make_grad_fn,
                                   make_prefill_step, make_serve_step)
    from repro_torch.train.optimizer import leaves, unflatten
    from repro_torch.weights import from_numpy

    arch, kinds, seq, batch_size = (case["arch"], case["kinds"],
                                    case["seq"], case["batch"])
    hyper = TrainHyper(accum_steps=case.get("accum", 1))
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=math.prod(case["mesh"]))
    mesh = init_device_mesh("cpu", tuple(case["mesh"]),
                            mesh_dim_names=tuple(case["names"]))
    torch.manual_seed(0)
    errs = {}
    margins = []

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def err(name, got, want):
        got, want = whole(got).detach().double(), want.detach().double()
        scale = max(float(want.abs().max()), 1e-30)
        errs[name] = max(errs.get(name, 0.0),
                         float((got - want).abs().max()) / scale)

    def unsharded(fn, *args):
        """``fn(*args)`` with the router's smallest top-k margin kept."""
        layers.ROUTE_LOG = []
        try:
            return fn(*args)
        finally:
            for c in layers.ROUTE_LOG:
                k = c["top_e"].shape[1]
                top = torch.topk(c["probs"], k + 1, dim=-1).values
                margins.append(float((top[:, k - 1] - top[:, k]).min()))
            layers.ROUTE_LOG = None

    def setup(kind):
        cfg, shape = cell_config(arch, ShapeConfig(kind, kind, seq,
                                                   batch_size),
                                 get_smoke_config(arch))
        cfg = cfg.replace(compute_dtype="float32", param_dtype="float32")
        model = get_model(cfg)
        rules = cell_rules(cfg, shape, mesh, hyper)
        if kind == "train" and case.get("params"):
            with np.load(case["params"]) as f:
                params = from_numpy(nest(dict(f)), "cpu")
        else:
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
        if "prefill" in kinds:
            model, rules, params, dparams, pl = setup("prefill")
            batch = {"tokens": inputs(model.cfg.vocab, (batch_size, seq), 1),
                     "labels": inputs(model.cfg.vocab, (batch_size, seq), 2)}
            dbatch = place(batch, pl)
            err("prefill_logits", model.forward(dparams, dbatch, rules),
                unsharded(model.forward, params, batch))
            got = make_prefill_step(model, rules)(dparams, dbatch)
            want = make_prefill_step(model)(params, batch)
            errs["prefill_tokens_differ"] = int(
                (got.full_tensor() != want).sum())

        if "decode" in kinds:
            model, rules, params, dparams, pl = setup("decode")
            cache = model.init_cache(batch_size, seq, device="cpu")
            if "cross" in cache:     # whisper: the encoder's K/V, random
                rng = np.random.RandomState(6)
                for t in cache["cross"].values():
                    t.copy_(torch.from_numpy(rng.randn(*t.shape)))
            dcache = distribute(tree_map(torch.clone, cache),
                                model.cache_schema(batch_size, seq), mesh,
                                rules)
            serve = make_serve_step(model)
            dserve = make_serve_step(model, rules)
            tokens = inputs(model.cfg.vocab, (batch_size, 1), 3)
            differ = 0
            for t in range(6):
                batch = {"tokens": tokens,
                         "pos": torch.full((batch_size,), t,
                                           dtype=torch.int32)}
                dbatch = place(batch, pl)
                logits, _ = unsharded(model.decode_step, params, cache,
                                      batch)
                dlogits, _ = model.decode_step(dparams, dcache, dbatch,
                                               rules)
                err("decode_logits", dlogits, logits)
                # the serve step advances a copy of each cache once more
                got, _ = dserve(dparams, tree_map(torch.clone, dcache),
                                dbatch)
                want, _ = serve(params, tree_map(torch.clone, cache), batch)
                differ += int((got.full_tensor() != want).sum())
                tokens = want[:, None]
            errs["decode_tokens_differ"] = differ

        if "train" in kinds:
            model, rules, params, dparams, pl = setup("train")
            batch = {"tokens": inputs(model.cfg.vocab, (batch_size, seq), 4),
                     "labels": inputs(model.cfg.vocab, (batch_size, seq), 5)}
            loss, _, grads = unsharded(make_grad_fn(model, hyper), params,
                                       batch)
            dloss, _, dgrads = make_grad_fn(model, hyper, rules)(
                dparams, place(batch, pl))
            dloss = whole(dloss)
            err("train_loss", dloss, loss)
            dgrads = [whole(dg) for dg in leaves(dgrads)]
            for g, dg in zip(leaves(grads), dgrads):
                err("train_grads", dg, g)
            if case.get("dump") and rank == 0:
                flat = flat_paths(unflatten(grads, dgrads))
                flat["loss"] = dloss
                np.savez(case["dump"], **{k: v.detach().numpy()
                                          for k, v in flat.items()})

    if margins:
        errs["min_margin"] = min(margins)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(errs, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(json.loads(sys.argv[1]), sys.argv[2], sys.argv[3],
            int(sys.argv[4]))
