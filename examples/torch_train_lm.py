"""End-to-end training driver of the PyTorch/CUDA port: train a small LM
with the full substrate — WTF-backed data pipeline (zero-copy epoch
shuffles), transactional async checkpointing, restart-safe cursor.  The
twin of ``examples/train_lm.py``.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]

Demonstrates crash-restart: the run checkpoints every 50 steps; re-running
the same command with the same ``--data-dir`` resumes from the latest
checkpoint with the data cursor exactly where the weights are.
"""
import argparse
import shutil
import sys
import tempfile

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/src")

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.core import Cluster
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.data.records import write_token_shard
from repro_torch.models import get_model
from repro_torch.models.common import resolve_device
from repro_torch.train import AdamWConfig, TrainHyper
from repro_torch.train.trainer import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-dir", default=None,
                    help="persist the WTF cluster here to test restart")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = resolve_device(args.device)
    data_dir = args.data_dir or tempfile.mkdtemp(prefix="wtf_train_")
    cluster = Cluster(n_servers=4, data_dir=data_dir, replication=2,
                      region_size=4 << 20)
    fs = cluster.client()

    # ---- synthetic corpus as a WTF token shard (structured so loss falls)
    cfg = get_smoke_config(args.arch).replace(max_seq=args.seq)
    model = get_model(cfg)
    rng = np.random.RandomState(0)
    n_tokens = args.batch * (args.seq + 1) * 64
    # a repeating Markov-ish stream: next token = (tok * 31 + noise) % vocab
    toks = np.zeros(n_tokens, np.int32)
    for i in range(1, n_tokens):
        toks[i] = (toks[i - 1] * 31 + 7 + (rng.randint(3) == 0)) % cfg.vocab
    if not fs.exists("/corpus"):
        fs.mkdir("/corpus")
        write_token_shard(fs, "/corpus/shard0", iter(toks), args.seq + 1)

    pipe = DataPipeline(fs, PipelineConfig(
        src_paths=("/corpus/shard0",), work_dir="/epochs",
        block_tokens=args.seq + 1, global_batch=args.batch, seed=0))
    ckpt = CheckpointManager(fs, "/ckpt", keep=3)
    trainer = Trainer(
        model, pipe, ckpt,
        hyper=TrainHyper(adamw=AdamWConfig(lr=1e-3, warmup_steps=20,
                                           decay_steps=args.steps)),
        cfg=TrainerConfig(total_steps=args.steps, ckpt_every=50,
                          log_every=10), device=device)
    resumed_from = ckpt.latest_step()
    if resumed_from:
        print(f"[torch_train_lm] resuming from step {resumed_from}")
    out = trainer.run()
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    print(f"[torch_train_lm] loss {first:.3f} -> {last:.3f} "
          f"over {args.steps} steps "
          f"({'improved' if last < first else 'NOT improved'})")
    cluster.close()
    if not args.data_dir:
        shutil.rmtree(data_dir, ignore_errors=True)
    return 0 if last < first else 1


if __name__ == "__main__":
    sys.exit(main())
