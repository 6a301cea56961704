"""Train driver of the port: the model stack on the WTF substrate.

  python -m repro_torch.launch.train --arch smollm-360m --steps 200 --smoke
  python -m repro_torch.launch.train --device cpu --smoke   # no card needed

The twin of the JAX package's ``repro.launch.train``: the same cluster
(4 servers, 2 replicas), corpus (random tokens written as a WTF token
shard), data pipeline, AdamW schedule and transactional checkpoints,
resumed from the latest one when ``--data-dir`` holds a previous run.
``--smoke`` takes the arch's reduced config; without it the published
one.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core import Cluster
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.data.records import write_token_shard
from repro_torch.models import get_model
from repro_torch.models.common import resolve_device
from repro_torch.train import AdamWConfig, TrainHyper
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config (default: published)")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch)).replace(max_seq=args.seq)
    model = get_model(cfg)
    data_dir = args.data_dir or tempfile.mkdtemp(prefix="wtf_launch_")
    cluster = Cluster(n_servers=4, data_dir=data_dir, replication=2)
    try:
        fs = cluster.client()
        if not fs.exists("/corpus"):
            fs.mkdir("/corpus")
            rng = np.random.RandomState(0)
            write_token_shard(
                fs, "/corpus/shard0",
                iter(rng.randint(0, cfg.vocab,
                                 args.batch * (args.seq + 1) * 64)),
                args.seq + 1)
        pipe = DataPipeline(fs, PipelineConfig(
            src_paths=("/corpus/shard0",), work_dir="/epochs",
            block_tokens=args.seq + 1, global_batch=args.batch, seed=0))
        trainer = Trainer(
            model, pipe, CheckpointManager(fs, "/ckpt", keep=3),
            hyper=TrainHyper(adamw=AdamWConfig(warmup_steps=20,
                                               decay_steps=args.steps),
                             accum_steps=args.accum),
            cfg=TrainerConfig(total_steps=args.steps), device=device)
        return trainer.run()
    finally:
        cluster.close()
        if not args.data_dir:
            shutil.rmtree(data_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
