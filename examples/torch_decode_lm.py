"""Batched greedy decode with the port's step functions, for the families
the paged engine does not serve: xlstm-1.3b (recurrent state),
whisper-medium (encoder, cross-attention K/V in the cache), zamba2-1.2b
and the MoE family.  The arch's smoke config with random weights.

  PYTHONPATH=src python examples/torch_decode_lm.py --arch xlstm-1.3b \
      --device cpu
  PYTHONPATH=src python examples/torch_decode_lm.py --arch whisper-medium \
      --device cpu

Whisper encodes random frame embeddings (the conv frontend is a stub, as
in the JAX package), fills the cache's cross K/V with `make_cross_kv`,
then decodes; the others prefill the prompt for its first token, then
decode.  Either way the prompt is teacher-forced through the decode step.
"""
import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/src")

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models import whisper
from repro_torch.train import make_prefill_step, make_serve_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    model = get_model(cfg)
    params = model.init(0, device=args.device)
    dev = params["embedding"].device
    rng = np.random.RandomState(0)
    b, n = args.batch, args.prompt_len
    prompts = torch.from_numpy(rng.randint(0, cfg.vocab, (b, n))).to(dev)
    cache = model.init_cache(b, n + args.max_new, device=dev)

    t0 = time.time()
    with torch.no_grad():
        if cfg.encdec is not None:
            frames = torch.from_numpy(rng.standard_normal(
                (b, cfg.encdec.encoder_seq, cfg.d_model)).astype(
                    np.float32)).to(dev)
            cache["cross"] = whisper.make_cross_kv(
                params, whisper.encode(params, frames, cfg), cfg)
            first = None
        else:
            first = make_prefill_step(model)(params, {"tokens": prompts})
        serve = make_serve_step(model)
        toks, out = prompts[:, :1], []
        for t in range(n + args.max_new - 1):
            pos = torch.full((b,), t, dtype=torch.int32, device=dev)
            nxt, cache = serve(params, cache, {"tokens": toks, "pos": pos})
            if t >= n - 1:
                out.append(nxt)
            toks = prompts[:, t + 1:t + 2] if t + 1 < n else nxt[:, None]
    tokens = torch.stack(out, dim=1).cpu()
    dt = time.time() - t0
    # an MoE layer's capacity depends on the call's token count, so its
    # prefill may drop other choices than its decode steps
    if first is not None and cfg.moe is None \
            and not torch.equal(first.cpu(), tokens[:, 0]):
        raise SystemExit("prefill and decode disagree on the first token")
    print(f"[decode] {cfg.name}: batch {b}, {n}-token prompts, "
          f"{args.max_new} new tokens each in {dt:.2f}s on {dev}")
    for i in range(min(b, 2)):
        print(f"[decode] seq {i}: {tokens[i].tolist()}")
    return tokens


if __name__ == "__main__":
    main()
