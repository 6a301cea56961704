"""The port's sharded train steps where a batch shard is small or the batch
is split twice: each case runs one smoke arch in 8 gloo processes with the
dry-run's rules (`repro_torch.launch.dryrun.cell_rules`, given the case's
``accum_steps`` as `make_grad_fn` is) and holds the loss and every
gradient leaf, and for olmoe-1b-7b also prefill and decode, against the
same steps run unsharded, within 1e-5 of each tensor's largest magnitude
(fp32; the worker is `tests/torch_sharded_worker.py`).

The cases:
  * the MoE block where a batch shard holds fewer rows than the model axis
    has ranks (olmoe-1b-7b on (2, 4) and granite-moe-3b-a800m on
    (2, 2, 2), batch 4): the flattened tokens and their gradient stay on
    the batch's placements;
  * gradient accumulation with the batch sharded on ("pod", "data")
    (olmoe-1b-7b, batch 16, and zamba2-1.2b, batch 8, on (2, 2, 2)): each
    microbatch is rows [i·B/k, (i+1)·B/k) of the global batch, as in the
    JAX package; an MoE step's capacity, drops and aux loss show whether
    the rows are right, where a dense loss would average the same;
  * accumulation with the batch on "data" alone (mistral-large-123b on
    (2, 4)), the path that shards the microbatch on one mesh dim.

The MoE cases print the smallest top-k margin met: a near-tie in the
router may flip a choice between two runs of the same function."""
import pytest
from torch_sharded_worker import check, run

POD = (2, 2, 2), ("pod", "data", "model")
DATA = (2, 4), ("data", "model")


@pytest.mark.parametrize("arch,kinds,batch,accum,mesh", [
    ("olmoe-1b-7b", ["prefill", "decode", "train"], 4, 1, DATA),
    ("granite-moe-3b-a800m", ["prefill", "decode", "train"], 4, 1, POD),
    ("olmoe-1b-7b", ["train"], 16, 2, POD),
    ("zamba2-1.2b", ["train"], 8, 2, POD),
    ("mistral-large-123b", ["train"], 16, 2, DATA),
])
def test_sharded_train_step_equals_unsharded(tmp_path, arch, kinds, batch,
                                             accum, mesh):
    errs = run(dict(arch=arch, kinds=kinds, seq=16, batch=batch,
                    accum=accum, mesh=list(mesh[0]), names=list(mesh[1])),
               tmp_path)
    print("ERRS", arch, errs)
    check(errs, kinds)
