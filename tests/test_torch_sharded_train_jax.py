"""The port's sharded train step held against the JAX package's sharded
train step, once for each of the two paths `tests/test_torch_sharded_train.py`
holds against the unsharded port: the MoE block where a batch shard holds
fewer rows than the model axis has ranks (olmoe-1b-7b, batch 4, (2, 4)),
and gradient accumulation with the batch on ("pod", "data") (zamba2-1.2b,
batch 8 in 2 microbatches, (2, 2, 2)).

JAX's side runs in a subprocess with 8 forced host devices, as
`tests/test_multidevice_subprocess.py` runs it: ``make_train_step`` of the
smoke config in fp32 (einsum attention), jitted over the mesh with the
params placed by `tree_shardings` and the batch by the rules fitted to it,
with the optimizer's update swapped (in that process only) for one that
hands the gradients back as the new params.  Its initial params go to the
port through `repro_torch.weights.from_numpy`, and the port's side is the
worker of `tests/torch_sharded_worker.py` with the dry-run's `cell_rules`.
The loss and every gradient leaf agree within 1e-5 of the largest
magnitude of JAX's tensor."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from torch_sharded_worker import SRC, check, run

TOL = 1e-5

_JAX = """
import sys, types
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec
from repro.configs import get_smoke_config
from repro.launch.dryrun import fit_batch_rule
from repro.launch.mesh import _make_mesh
from repro.models import get_model
from repro.parallel.sharding import make_rules, spec_for, tree_shardings
from repro.train import TrainHyper, make_train_step, optimizer
from repro.train import step as step_mod

arch, batch, seq, accum = sys.argv[1], *map(int, sys.argv[2:5])
shape, names = eval(sys.argv[5]), eval(sys.argv[6])
params_out, grads_out = sys.argv[7], sys.argv[8]
mesh = _make_mesh(shape, names)
cfg = get_smoke_config(arch).replace(attn_impl="xla",
                                     compute_dtype="float32",
                                     param_dtype="float32")
model = get_model(cfg)
rules = fit_batch_rule(mesh, make_rules(mesh, **dict(cfg.rules_overrides)),
                       batch)
params = model.init(jax.random.PRNGKey(0))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {prefix + k: np.asarray(v)})
    return out


np.savez(params_out, **flat(params))
state = {"params": params, "opt": optimizer.init(params),
         "step": jnp.zeros((), jnp.int32)}
rng = lambda s: np.random.RandomState(s).randint(  # noqa: E731
    0, cfg.vocab, (batch, seq)).astype(np.int32)
inputs = {"tokens": rng(4), "labels": rng(5)}
psh = tree_shardings(model.schema(), mesh, rules)
rep = NamedSharding(mesh, PartitionSpec())
ssh = {"params": psh,
       "opt": type(state["opt"])(m=psh, v=psh, count=rep), "step": rep}
bsh = {k: NamedSharding(mesh, spec_for(("batch", None), rules))
       for k in inputs}
# the step's update, swapped for one that returns the gradients
step_mod.opt = types.SimpleNamespace(
    update=lambda cfg, grads, opt_state, params: (grads, opt_state, {}))
step = make_train_step(model, TrainHyper(accum_steps=accum), rules)
with mesh:
    new, metrics = jax.jit(step, in_shardings=(ssh, bsh))(state, inputs)
grads = flat(new["params"])
grads["loss"] = np.asarray(metrics["loss"])
np.savez(grads_out, **grads)
print("batch rule", rules["batch"])
"""


@pytest.mark.parametrize("arch,batch,accum,mesh,names", [
    ("olmoe-1b-7b", 4, 1, (2, 4), ("data", "model")),
    ("zamba2-1.2b", 8, 2, (2, 2, 2), ("pod", "data", "model")),
])
def test_sharded_train_step_equals_jax(tmp_path, arch, batch, accum, mesh,
                                       names):
    seq = 16
    params, jgrads, tgrads = (str(tmp_path / f) for f in
                              ("params.npz", "jax.npz", "torch.npz"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX), arch, str(batch),
         str(seq), str(accum), repr(mesh), repr(names), params, jgrads],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    print(out.stdout.strip())
    errs = run(dict(arch=arch, kinds=["train"], seq=seq, batch=batch,
                    accum=accum, mesh=list(mesh), names=list(names),
                    params=params, dump=tgrads), tmp_path / "port")
    print("ERRS vs the unsharded port", arch, errs)
    check(errs, ["train"])
    with np.load(jgrads) as want, np.load(tgrads) as got:
        assert sorted(got.files) == sorted(want.files)
        worst = 0.0
        for name in want.files:
            w, g = want[name].astype(np.float64), got[name]
            e = float(np.abs(g - w).max()) / max(float(np.abs(w).max()),
                                                 1e-30)
            assert e <= TOL, (name, e)
            worst = max(worst, e)
    print("largest error vs JAX's sharded step", arch, worst)
