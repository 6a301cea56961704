"""Batched serving with the port's paged KV engine: continuous batching,
prefix sharing (WTF `copy` on KV pages) and the CUDA paged-attention
kernel (its plain version on the CPU).  The twin of
``examples/serve_lm.py``.

  PYTHONPATH=src python examples/torch_serve_lm.py [--arch command-r-35b]
                                                   [--device cpu]
"""
import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/src")

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.serving import Engine, EngineConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    model = get_model(cfg)
    params = model.init(0, device=args.device)
    eng = Engine(model, params, EngineConfig(page_tokens=8, num_pages=512,
                                             device=args.device))

    rng = np.random.RandomState(0)
    system_prompt = rng.randint(0, cfg.vocab, 24).astype(np.int32)

    # eight requests sharing the same 24-token system prompt: the shared
    # pages are forked (refcounted), not copied
    base = eng.add(system_prompt, max_new=8)
    t0 = time.time()
    sids = [base]
    for _ in range(7):
        user = rng.randint(0, cfg.vocab, 8).astype(np.int32)
        sids.append(eng.add(np.concatenate([system_prompt, user]),
                            max_new=8, fork_from=base))
    steps = 0
    while any(not eng._requests[s].done for s in sids):
        eng.step()
        steps += 1
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    stats = eng.cache.stats
    print(f"[serve] {cfg.name}: 8 requests × 8 tokens in {steps} batched "
          f"steps, {dt:.2f}s on {eng.device}")
    print(f"[serve] pages: allocated={stats['pages_allocated']} "
          f"shared={stats['pages_shared']} cow={stats['pages_copied']}")
    for s in sids[:3]:
        print(f"[serve] seq {s}: {eng.result(s)}")
    total_tokens = sum(len(eng.result(s)) for s in sids)
    print(f"[serve] throughput: {total_tokens / dt:.1f} tok/s")
    return {s: eng.result(s) for s in sids}


if __name__ == "__main__":
    main()
