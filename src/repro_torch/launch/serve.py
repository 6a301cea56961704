"""Serve driver of the port: paged-KV continuous-batching engine.

  python -m repro_torch.launch.serve --arch qwen2-7b --requests 16
  python -m repro_torch.launch.serve --device cpu       # no card needed

Runs the arch's smoke config with random weights, as the JAX package's
``repro.launch.serve`` does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.models import get_model
from repro_torch.serving import Engine, EngineConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen2-7b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if cfg.arch_kind not in ("dense", "vlm"):
        raise SystemExit(f"{args.arch}: paged engine serves the dense "
                         "family; use examples/ for SSM decode")
    model = get_model(cfg)
    params = model.init(0, device=args.device)
    eng = Engine(model, params, EngineConfig(
        page_tokens=args.page_tokens,
        num_pages=max(1024, args.requests * 64), device=args.device))

    rng = np.random.RandomState(0)
    t0 = time.time()
    sids = [eng.add(rng.randint(0, cfg.vocab,
                                args.prompt_len).astype(np.int32),
                    max_new=args.max_new)
            for _ in range(args.requests)]
    steps = 0
    while any(not eng._requests[s].done for s in sids):
        eng.step()
        steps += 1
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    tokens = sum(len(eng.result(s)) for s in sids)
    print(f"[serve] {args.requests} requests, {tokens} tokens, "
          f"{steps} steps, {dt:.2f}s on {eng.device} → "
          f"{tokens / dt:.1f} tok/s")
    print(f"[serve] page stats: {eng.cache.stats}")


if __name__ == "__main__":
    main()
