"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases, one line each; a failing phase raises and nothing catches it:

1. card: the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/csrc`` (one nvcc per source, all started together).
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the serving path, and the times of kernel, plain version
   and (for flash) the PyTorch library call, with CUDA events.
3. parity: qwen2-7b at full width, 2 layers, fp32 (TF32 off): the engine's
   greedy tokens (kernels) equal teacher-forced greedy tokens from the
   port's kernel-free ``dense.forward``.
4. serve: qwen2-7b at full width (28 layers), bf16, random weights from
   seed 0; a 500-token system prompt and 7 forks of it with 64-token
   suffixes, 32 new tokens each.  The launch counts of both kernels must
   match the path.

It imports nothing of JAX or of the JAX package ``repro``.  The last line
is ``{"ok": true, "device": {...}}``; before it come the ``kernels`` JSON
line and the card's ``nvidia-smi`` name and power limit.  Exits nonzero,
with no result, where torch sees no CUDA card.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, dense bf16
# tensor-core rate, fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
FLASH_SHAPE = dict(b=1, h=28, hkv=4, d=128)       # qwen2-7b prefill
PAGED_SHAPE = dict(b=8, h=28, hkv=4, d=128, t=16, pages=2048)
SERVE_PROMPT, SERVE_SUFFIX, SERVE_FORKS, SERVE_NEW = 500, 64, 7, 32


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn``, by CUDA events around each
    call.  The 50 MB L2 is overwritten before every call, outside the
    events: the serving path finds a kernel's inputs cold."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out: torch.Tensor, ref: torch.Tensor, dtype, what: str) -> float:
    tol = TOL[dtype]
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    if not torch.allclose(out, ref, atol=tol, rtol=tol):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version, max |err| "
                             f"{(out - ref).abs().max().item():.3e}")
    return (out - ref).abs().max().item()


# ---------------------------------------------------------------- phase 1
def phase_card() -> str:
    from repro_torch.kernels import _build
    card = nvidia_smi()
    log("card", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), smi=repr(card),
        torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    logs = _build.build(["flash_attention", "paged_attention"],
                        extra_flags=["-Xptxas", "-v"])
    log("build", seconds=f"{time.perf_counter() - t0:.3f}",
        built=",".join(sorted(logs)) or "cached")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    return card


# ---------------------------------------------------------------- phase 2
def phase_kernels(gen: torch.Generator) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_fwd
    from repro_torch.kernels.paged_attention import paged_attention_plain
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_fwd

    dev = torch.device("cuda")
    b, h, hkv, d = (FLASH_SHAPE[k] for k in ("b", "h", "hkv", "d"))
    flash_errs = []

    def qkv(s, dtype):
        # q, k, v as slices of one fused projection output, as strided
        # [B, S, H, D] views (the kernel reads them through their strides)
        fused = torch.randn((b, s, h + 2 * hkv, d), generator=gen,
                            device=dev, dtype=torch.float32).to(dtype)
        return fused[:, :, :h], fused[:, :, h:h + hkv], fused[:, :, h + hkv:]

    cases = [(s, dt, None) for s in (500, 512, 564, 576)
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(576, torch.bfloat16, 128), (576, torch.float32, 200)]
    for s, dt, window in cases:
        q, k, v = qkv(s, dt)
        out = flash_attention_fwd(q, k, v, causal=True,
                                  sliding_window=window)
        torch.cuda.synchronize()
        ref = attention_plain(q, k, v, causal=True, sliding_window=window)
        err = max_err(out, ref, dt, f"flash S={s} {dt} window={window}")
        if dt == torch.bfloat16:
            flash_errs.append(err)
        log("kernels", kernel="flash_attention", S=s, dtype=str(dt),
            window=window, max_abs_err=f"{err:.3e}")

    # timing at the forks' prefill shape (7 of the 8 prefills), bf16
    s = SERVE_PROMPT + SERVE_SUFFIX
    q, k, v = (t.contiguous() for t in qkv(s, torch.bfloat16))
    f_ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
    f_plain = cuda_ms(lambda: attention_plain(q, k, v, causal=True), 5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        f_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    except TypeError:           # a PyTorch without enable_gqa (< 2.5)
        f_lib = None
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    flops = 4 * d * b * h * s * (s + 1) / 2
    f_bound, f_by = bound(nbytes, flops, torch.bfloat16)

    pb, ph, phkv, pd, pt, npages = (PAGED_SHAPE[k] for k in
                                    ("b", "h", "hkv", "d", "t", "pages"))
    paged_errs = []

    def paged_inputs(lengths, dtype):
        pool = torch.randn((2, 2, npages, pt, phkv, pd), generator=gen,
                           device=dev, dtype=torch.float32).to(dtype)
        q = torch.randn((pb, ph, pd), generator=gen, device=dev,
                        dtype=torch.float32).to(dtype)
        pp = -(-max(lengths) // pt) + 1           # one unused -1 column
        tbl = torch.full((pb, pp), -1, dtype=torch.int32)
        free = torch.randperm(npages - 1, generator=torch.Generator()
                              .manual_seed(0)) + 1
        used = 0
        for i, ln in enumerate(lengths):
            n = -(-ln // pt)
            tbl[i, :n] = free[used:used + n].to(torch.int32)
            used += n
        lens = torch.tensor(lengths, dtype=torch.int32)
        # layer 1 of a [L, P, T, Hkv, D] pool: a strided view
        return q, pool[0, 1], pool[1, 1], tbl.to(dev), lens.to(dev)

    mixed = [1, 16, 17, 255, 256, 511, 592, 600]   # incl. page multiples
    for dt in (torch.bfloat16, torch.float32):
        args = paged_inputs(mixed, dt)
        out = paged_attention_fwd(*args)
        torch.cuda.synchronize()
        err = max_err(out, paged_attention_plain(*args), dt,
                      f"paged {dt}")
        if dt == torch.bfloat16:
            paged_errs.append(err)
        log("kernels", kernel="paged_attention", lengths=mixed,
            dtype=str(dt), max_abs_err=f"{err:.3e}")

    # timing at a mid-run decode step of the serve phase: the base request
    # and 7 forks, 15 tokens in
    serve_lens = [SERVE_PROMPT + 16] + [s + 16] * SERVE_FORKS
    args = paged_inputs(serve_lens, torch.bfloat16)
    err = max_err(paged_attention_fwd(*args), paged_attention_plain(*args),
                  torch.bfloat16, "paged serve lengths")
    paged_errs.append(err)
    p_ms = cuda_ms(lambda: paged_attention_fwd(*args))
    p_plain = cuda_ms(lambda: paged_attention_plain(*args), 5)
    ntok = sum(serve_lens)
    nbytes = (2 * ntok * phkv * pd * 2 + 2 * 2 * pb * ph * pd
              + 4 * args[3].numel() + 4 * pb)
    flops = 4 * pd * ph * ntok
    p_bound, p_by = bound(nbytes, flops, torch.bfloat16)

    kernels = {
        "flash_attention": {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:100",
            "max_abs_err": max(flash_errs), "ms": f_ms, "kernel_ms": f_ms,
            "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by,
            "library_ms": f_lib,
            "shape": f"B={b} S={s} H={h} Hkv={hkv} D={d} causal bf16"},
        "paged_attention": {
            "name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:76",
            "max_abs_err": max(paged_errs), "ms": p_ms, "kernel_ms": p_ms,
            "plain_ms": p_plain, "bound_ms": p_bound, "bound_by": p_by,
            "library_ms": None,
            "shape": f"B={pb} H={ph} Hkv={phkv} D={pd} T={pt} "
                     f"lengths={serve_lens} bf16"},
    }
    for kern in kernels.values():
        log("kernels", **{k: kern[k] for k in
                          ("name", "ms", "plain_ms", "library_ms",
                           "bound_ms", "bound_by")})
    return kernels


# ---------------------------------------------------------------- phase 3
def phase_parity(gen: torch.Generator) -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen2-7b").replace(n_layers=2, compute_dtype="float32",
                                         attn_impl="pallas")
    model = get_model(cfg)
    params = model.init(gen, device="cuda")
    eng = Engine(model, params, EngineConfig(page_tokens=16, num_pages=256))
    rng = np.random.RandomState(1)
    base = rng.randint(0, cfg.vocab, 40).astype(np.int32)   # 2.5 pages
    prompts = [base,
               np.concatenate([base, rng.randint(0, cfg.vocab, 5)])
               .astype(np.int32),
               rng.randint(0, cfg.vocab, 23).astype(np.int32)]
    fk.launches = pk.launches = 0
    a = eng.add(prompts[0], max_new=8)
    sids = [a, eng.add(prompts[1], max_new=8, fork_from=a),
            eng.add(prompts[2], max_new=8)]
    steps = 0
    while any(not eng._requests[s].done for s in sids):
        eng.step()
        steps += 1
    if (fk.launches, pk.launches) != (3 * 2, steps * 2):
        raise AssertionError(f"parity path launches flash {fk.launches} "
                             f"paged {pk.launches}, steps {steps}")
    if eng.cache.stats["pages_copied"] < 1:
        raise AssertionError("the mid-page fork did not copy its page")

    ref_model = get_model(cfg.replace(attn_impl="xla"))
    with torch.no_grad():
        for sid, prompt in zip(sids, prompts):
            out = eng.result(sid)
            seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
            logits = ref_model.forward(
                params, {"tokens": torch.from_numpy(seq)[None].cuda()})
            if not torch.isfinite(logits).all():
                raise AssertionError("non-finite reference logits")
            want = logits[0, len(prompt) - 1:].argmax(-1).tolist()
            if want != out:
                raise AssertionError(f"seq {sid}: engine {out} vs "
                                     f"teacher-forced forward {want}")
    log("parity", arch="qwen2-7b", layers=2, dtype="float32",
        requests=len(sids), steps=steps, tokens_equal=True,
        pages=eng.cache.stats)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4
def profile_window(name: str, fn) -> None:
    """Run ``fn`` under torch.profiler; print the wall time, the device's
    busy time and idle share, and the kernels that took the most device
    time in the window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    log("profile", window=name, wall_ms=f"{wall_ms:.3f}",
        device_busy_ms=f"{busy_ms:.3f}",
        device_idle_share=f"{1 - busy_ms / wall_ms:.4f}",
        device_ops=len(kernels))
    for kname, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"[profile] {name}: {t:9.3f} ms {n:5d}x {kname[:90]}")


def phase_serve(gen: torch.Generator, profile: bool = False) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig

    cfg = get_config("qwen2-7b").replace(attn_impl="pallas")
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(gen, device="cuda")              # fp32, ~30.5 GB
    eng = Engine(model, params, EngineConfig(page_tokens=16,
                                             num_pages=2048))
    setup_peak = torch.cuda.max_memory_allocated()
    del params                           # the engine holds its bf16 copy
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    rng = np.random.RandomState(0)
    system = rng.randint(0, cfg.vocab, SERVE_PROMPT).astype(np.int32)
    prompts = [system] + [
        np.concatenate([system, rng.randint(0, cfg.vocab, SERVE_SUFFIX)])
        .astype(np.int32) for _ in range(SERVE_FORKS)]

    fk.launches = pk.launches = 0
    prefill_ms = []
    sids = []
    for i, prompt in enumerate(prompts):
        t0 = time.perf_counter()
        sids.append(eng.add(prompt, max_new=SERVE_NEW,
                            fork_from=sids[0] if i else None))
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = []
    while any(not eng._requests[s].done for s in sids):
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"flash_attention": fk.launches,
                "paged_attention": pk.launches}

    n_layers = cfg.n_layers
    if launches["flash_attention"] != n_layers * len(prompts):
        raise AssertionError(f"flash launches {launches} for "
                             f"{len(prompts)} prefills")
    if launches["paged_attention"] != n_layers * len(step_ms):
        raise AssertionError(f"paged launches {launches} for "
                             f"{len(step_ms)} decode steps")
    for sid in sids:
        out = eng.result(sid)
        if len(out) != SERVE_NEW or not all(0 <= t < cfg.vocab
                                            for t in out):
            raise AssertionError(f"seq {sid}: {out}")
    used = sorted({p for s in sids for p in eng.cache.page_table[s]})
    for pool in (eng.k_pool, eng.v_pool):
        if not torch.isfinite(pool[:, used]).all():
            raise AssertionError("non-finite K/V in the pages in use")
    if eng.cache.stats["pages_copied"] != SERVE_FORKS:
        raise AssertionError(f"page stats {eng.cache.stats}")

    total_s = (sum(prefill_ms) + sum(step_ms)) / 1e3
    tokens = sum(len(eng.result(s)) for s in sids)
    log("serve", arch="qwen2-7b", layers=n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab, dtype=cfg.compute_dtype, requests=len(sids),
        tokens=tokens, decode_steps=len(step_ms),
        tokens_per_s=f"{tokens / total_s:.3f}",
        prefill_ms_per_request=f"{np.mean(prefill_ms):.3f}",
        prefill_ms=[round(x, 3) for x in prefill_ms],
        decode_ms_per_step=f"{np.mean(step_ms):.3f}",
        decode_ms_median=f"{np.median(step_ms):.3f}",
        setup_s=f"{setup_s:.3f}",
        setup_peak_gb=f"{setup_peak / 1e9:.3f}",
        serve_peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        launches=launches, pages=eng.cache.stats)
    if profile:
        # the same traffic again, outside the counted run: its 8 prefills,
        # then 8 decode steps after 2 unprofiled ones
        sids = []
        profile_window("prefill x8", lambda: sids.extend(
            eng.add(p, max_new=SERVE_NEW, fork_from=sids[0] if i else None)
            for i, p in enumerate(prompts)))
        eng.step()
        eng.step()
        profile_window("decode x8", lambda: [eng.step() for _ in range(8)])
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card; this script runs on the "
              "GPU only", file=sys.stderr)
        return 1
    # with no arguments every phase runs and the result lines are printed;
    # naming phases (kernels, parity, serve, profile) runs just those, to
    # debug or to profile the serve phase
    phases = sys.argv[1:] or ["kernels", "parity", "serve"]
    card = phase_card()
    if "kernels" in phases:
        kernels = phase_kernels(torch.Generator(device="cuda").manual_seed(2))
    if "parity" in phases:
        phase_parity(torch.Generator(device="cuda").manual_seed(1))
    if "serve" in phases or "profile" in phases:
        launches = phase_serve(torch.Generator(device="cuda").manual_seed(0),
                               profile="profile" in phases)
    if sys.argv[1:]:
        return 0
    for name, kern in kernels.items():
        kern["launches"] = launches[name]
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
