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
The worker is `tests/torch_sharded_worker.py`, shared with
`tests/test_torch_sharded_train.py`.

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
import pytest
from torch_sharded_worker import check, run


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
    errs = run(dict(arch=arch, kinds=kinds, seq=seq, batch=batch,
                    mesh=list(mesh), names=list(names)), tmp_path)
    print("ERRS", arch, errs)
    check(errs, kinds)
