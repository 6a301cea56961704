"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py                        # every phase, the result
  python3 chip_smoke.py zamba2_serve profile   # named phases only, traced

Phases, one line each; a failing phase raises and nothing catches it:

1. card: the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/csrc`` (one nvcc per source, all started together),
   with each kernel's registers and spills and its count of tensor-core
   SASS instructions (HGMMA: wgmma, HMMA: mma.sync) where a disassembler
   is found.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the serving paths (flash at both qwen2-7b's and zamba2's
   prefill shapes, and at head dim 32; paged at bf16 and fp32, head dims
   32/64/128, 1/7/8/32 query heads per kv head and 8/16/64-token pages,
   a batch whose table leaves every span but the first empty, and 33
   heads per kv head and a pool view that 16-byte copies cannot read,
   which must raise; for the SSD scan also one chunk, a
   sequence shorter than the chunk, the smoke sizes, a given initial state
   and a dt large enough that an unmasked decay overflows; a chunk too
   large for shared memory must fail to launch), and the times of kernel,
   plain version and (for flash) the PyTorch library call, with CUDA
   events, kernel and its yardstick timed in turns; paged also with the
   serve run's shared-prefix table.
3. parity: qwen2-7b at full width, 2 layers, fp32 (TF32 off): the engine's
   greedy tokens (kernels) equal teacher-forced greedy tokens from the
   port's kernel-free ``dense.forward``.
4. serve: qwen2-7b at full width (28 layers), bf16, random weights from
   seed 0; a 500-token system prompt and 7 forks of it with 64-token
   suffixes, 32 new tokens each.  The launch counts of both kernels must
   match the path.
5. zamba2_parity: zamba2-1.2b at full width, 7 layers (one group, its
   shared-attention site, one more layer), fp32 (TF32 off), B=2, S=256:
   the logits of ``forward`` (SSD-scan and flash kernels) equal those of
   ``decode_step`` stepped token by token from ``init_cache`` (no kernel)
   within 2e-3, and so do their greedy tokens.
6. zamba2_serve: zamba2-1.2b at full width and depth (38 layers), bf16,
   random weights from seed 0: ``make_prefill_step`` on 4 prompts of 4096
   tokens (38 SSD-scan and 6 flash launches per call), then
   ``make_serve_step`` at batch 8 against ``init_cache(8, 4096)``: 128
   teacher-forced prompt tokens, then 64 greedy ones (no SSD launch).

Run it from the root of a checkout: it imports ``src/`` of the working
directory.  It imports nothing of JAX or of the JAX package ``repro``.
The last line
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

# the port of the checkout it is run from: its root is the working
# directory (so scripts/chip_ab.py can run this script over another tree)
sys.path.insert(0, os.path.join(os.getcwd(), "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, dense bf16
# tensor-core rate, fp32 rate outside the tensor cores, and the rate of
# fp32-accurate products on the tensor cores: split TF32 (hi·hi + hi·lo +
# lo·hi) takes three TF32 products at 495 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SPLIT_TF32_FLOPS = 495e12 / 3
SLEEP_CYCLES = 2_000_000            # ~1.1 ms at the H100's 1.83 GHz boost
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# the JAX package's own SSD tolerance (tests/test_kernels.py): the kernel
# sums its chunk products in another order than the plain version, and y
# grows with the chunk length
SSD_TOL = 2e-3
FLASH_SHAPE = dict(b=1, h=28, hkv=4, d=128)       # qwen2-7b prefill
Z_FLASH_SHAPE = dict(b=4, s=4096, h=32, hkv=32, d=64)   # zamba2 prefill
PAGED_SHAPE = dict(b=8, h=28, hkv=4, d=128, t=16, pages=2048)
SSD_SHAPE = dict(b=4, s=4096, h=64, p=64, n=64, chunk=128)  # zamba2 prefill
KERNEL_LIBS = ["flash_attention", "paged_attention", "mamba2_scan"]
PORT_KERNELS = ("flash_bf16", "flash_fp32", "paged_fwd", "paged_merge",
                "chunk_states", "state_pass", "chunk_outputs")
SERVE_PROMPT, SERVE_SUFFIX, SERVE_FORKS, SERVE_NEW = 500, 64, 7, 32
Z_PREFILL_B, Z_PREFILL_S, Z_PREFILLS = 4, 4096, 3
Z_DECODE_B, Z_CACHE_LEN, Z_PROMPT, Z_NEW = 8, 4096, 128, 64


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


def timed_call(fn, flush: torch.Tensor) -> tuple:
    """CUDA events around one call of ``fn``.  The 50 MB L2 is overwritten
    first, outside the events (the serving path finds a kernel's inputs
    cold), and the card is then kept busy for ~1 ms while the host enqueues
    the events and the call, so the host's launch time stays outside."""
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    flush.zero_()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    fn()
    end.record()
    return start, end


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn`` (`timed_call`)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = [timed_call(fn, flush) for _ in range(iters)]
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def cuda_ms_turns(fns: dict, rounds: int = 10, warmup: int = 2) -> dict:
    """Median device time of one call of each of ``fns``, timed in turns
    (a, b, b, a, ...) by `timed_call`, so that the functions share the
    card's state."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    names = list(fns)
    events = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            events[n].append(timed_call(fns[n], flush))
    torch.cuda.synchronize()
    return {n: float(np.median([s.elapsed_time(e) for s, e in ev]))
            for n, ev in events.items()}


def host_us(fn, calls: int = 200) -> float:
    """Mean host time of one call of ``fn``, in us: the calls are enqueued
    behind ~45 ms of device sleep, so no call waits for the card.  What
    the host pays per call on a host-bound step."""
    torch.cuda.synchronize()
    torch.cuda._sleep(40 * SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def bound(nbytes: float, flops: float, rate: float) -> tuple:
    """(least time in ms, what bounds it): bytes over the HBM rate or
    operations over ``rate``, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out: torch.Tensor, ref: torch.Tensor, dtype, what: str,
            tol: float = None) -> float:
    tol = TOL[dtype] if tol is None else tol
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
    logs = _build.build(KERNEL_LIBS, extra_flags=["-Xptxas", "-v"])
    log("build", seconds=f"{time.perf_counter() - t0:.3f}",
        built=",".join(sorted(logs)) or "cached")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    for name in KERNEL_LIBS:
        counts = sass_counts(_build.library_path(name))
        if counts is None:
            log("build", library=name, sass="not available")
        for func, (hgmma, hmma) in (counts or {}).items():
            log("build", library=name, kernel=func, HGMMA=hgmma, HMMA=hmma)
    return card


def sass_counts(lib) -> dict:
    """{kernel: (HGMMA count, HMMA count)} from ``cuobjdump -sass`` of a
    built library, or None where no cuobjdump is found (the toolkit's, or
    the copy Triton carries)."""
    import shutil
    from torch.utils.cpp_extension import CUDA_HOME
    tools = [shutil.which("cuobjdump")]
    if CUDA_HOME:
        tools.append(os.path.join(CUDA_HOME, "bin", "cuobjdump"))
    try:
        import triton
        tools.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    tool = next((x for x in tools if x and os.path.exists(x)), None)
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        func, body = part.split("\n", 1)
        counts[demangle(func.strip())] = (body.count("HGMMA"),
                                          body.count("HMMA"))
    return counts


def demangle(symbol: str) -> str:
    try:
        out = subprocess.run(["c++filt", symbol], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except OSError:
        return symbol
    # the kernel's name and template arguments, without its parameters
    out = out.replace("(anonymous namespace)::", "").split("(")[0]
    return out.removeprefix("void ").replace(" ", "") or symbol


# ---------------------------------------------------------------- phase 2
def phase_kernels(gen: torch.Generator) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_fwd

    dev = torch.device("cuda")
    flash_errs = []

    def qkv(b, s, h, hkv, d, dtype):
        # q, k, v as slices of one fused projection output, as strided
        # [B, S, H, D] views (the kernel reads them through their strides)
        fused = torch.randn((b, s, h + 2 * hkv, d), generator=gen,
                            device=dev, dtype=torch.float32).to(dtype)
        return fused[:, :, :h], fused[:, :, h:h + hkv], fused[:, :, h + hkv:]

    def flash_case(b, s, h, hkv, d, dt, window):
        q, k, v = qkv(b, s, h, hkv, d, dt)
        out = flash_attention_fwd(q, k, v, causal=True,
                                  sliding_window=window)
        torch.cuda.synchronize()
        ref = attention_plain(q, k, v, causal=True, sliding_window=window)
        err = max_err(out, ref, dt, f"flash B={b} S={s} H={h} D={d} {dt} "
                                    f"window={window}")
        if dt == torch.bfloat16:
            flash_errs.append(err)
        log("kernels", kernel="flash_attention", B=b, S=s, H=h, Hkv=hkv, D=d,
            dtype=str(dt), window=window, max_abs_err=f"{err:.3e}")

    fs = FLASH_SHAPE
    for s in (500, 512, 564, 576):
        for dt in (torch.bfloat16, torch.float32):
            flash_case(fs["b"], s, fs["h"], fs["hkv"], fs["d"], dt, None)
    flash_case(fs["b"], 576, fs["h"], fs["hkv"], fs["d"], torch.bfloat16, 128)
    flash_case(fs["b"], 576, fs["h"], fs["hkv"], fs["d"], torch.float32, 200)
    for dt in (torch.bfloat16, torch.float32):          # head dim 32
        flash_case(2, 300, 4, 2, 32, dt, None)
    zs = Z_FLASH_SHAPE
    flash_case(zs["b"], zs["s"], zs["h"], zs["hkv"], zs["d"], torch.bfloat16,
               None)

    def flash_times(b, s, h, hkv, d, what):
        """Kernel and library call in turns, plain version alone, at one
        causal bf16 shape with contiguous inputs; bound from the shape."""
        q, k, v = (t.contiguous() for t in qkv(b, s, h, hkv, d,
                                                 torch.bfloat16))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fns = {"kernel": lambda: flash_attention_fwd(q, k, v, causal=True),
               "library": lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True)}
        try:
            fns["library"]()
        except TypeError:       # a PyTorch without enable_gqa (< 2.5)
            del fns["library"]
        ms = cuda_ms_turns(fns)
        plain = cuda_ms(lambda: attention_plain(q, k, v, causal=True), 5)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        flops = 4 * d * b * h * s * (s + 1) / 2
        t_bound, by = bound(nbytes, flops, PEAK_FLOPS[torch.bfloat16])
        del q, k, v, qt, kt, vt
        return {"shape": f"B={b} S={s} H={h} Hkv={hkv} D={d} causal bf16",
                "path": what, "ms": ms["kernel"], "kernel_ms": ms["kernel"],
                "plain_ms": plain, "library_ms": ms.get("library"),
                "bound_ms": t_bound, "bound_by": by, "bytes": nbytes,
                "flops": flops}

    # timing at the forks' prefill shape (7 of qwen2-7b's 8 prefills) and
    # at zamba2-1.2b's
    s = SERVE_PROMPT + SERVE_SUFFIX
    flash_shapes = [
        flash_times(fs["b"], s, fs["h"], fs["hkv"], fs["d"],
                    "qwen2-7b serve"),
        flash_times(zs["b"], zs["s"], zs["h"], zs["hkv"], zs["d"],
                    "zamba2-1.2b serve")]
    for sh in flash_shapes:
        log("kernels", kernel="flash_attention", **{
            k: sh[k] for k in ("path", "ms", "plain_ms", "library_ms",
                               "bound_ms", "bound_by")})

    kernels = {
        "flash_attention": {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:100",
            "max_abs_err": max(flash_errs),
            **{k: flash_shapes[0][k] for k in (
                "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape")},
            "shapes": flash_shapes},
    }
    kernels["paged_attention"] = paged_kernel(gen)
    kernels["mamba2_scan"] = ssd_kernel(gen)
    for kern in kernels.values():
        log("kernels", **{k: kern[k] for k in
                          ("name", "ms", "plain_ms", "library_ms",
                           "bound_ms", "bound_by")})
    return kernels


def paged_kernel(gen: torch.Generator) -> dict:
    """The paged decode-attention kernel against its plain version at every
    dtype, head dim 32/64/128, 1/7/8/32 query heads per kv head and
    8/16/64 token pages, at lengths around page and tile edges; a batch
    that leaves every span of the table but the first empty (with a length
    of 0); a group the kernel does not take and a pool it cannot read by
    16-byte copies (both must raise); and its times at a
    mid-run decode step of the qwen2-7b serve phase, with a table of
    scattered pages and with the serve run's own shape of table (the
    system prompt's pages shared by all 8 sequences)."""
    import itertools
    from repro_torch.kernels.paged_attention import paged_attention_plain
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_fwd

    dev = torch.device("cuda")
    sv = PAGED_SHAPE

    def inputs(lengths, dtype, *, h=sv["h"], hkv=sv["hkv"], d=sv["d"],
               t=sv["t"], pages=None, shared=0, extra_cols=1):
        """q and a table of distinct random pages (-1 past each length,
        ``extra_cols`` unused columns); the first ``shared`` columns of
        every row name sequence 0's pages, as prefix forks do.  The pools
        are layer 1 of a [L, P, T, Hkv, D] pool, a strided view."""
        need = sum(-(-ln // t) for ln in lengths)
        pages = pages or need + 64
        pool = torch.randn((2, 2, pages, t, hkv, d), generator=gen,
                           device=dev, dtype=torch.float32).to(dtype)
        q = torch.randn((len(lengths), h, d), generator=gen, device=dev,
                        dtype=torch.float32).to(dtype)
        pp = -(-max(lengths) // t) + extra_cols
        tbl = torch.full((len(lengths), pp), -1, dtype=torch.int32)
        free = torch.randperm(pages - 1, generator=torch.Generator()
                              .manual_seed(0)) + 1
        used = 0
        for i, ln in enumerate(lengths):
            n = -(-ln // t)
            tbl[i, :n] = free[used:used + n].to(torch.int32)
            used += n
        tbl[:, :shared] = tbl[0, :shared]
        lens = torch.tensor(lengths, dtype=torch.int32)
        return q, pool[0, 1], pool[1, 1], tbl.to(dev), lens.to(dev)

    errs = {torch.bfloat16: [], torch.float32: []}

    def check(args, dtype, what):
        out = paged_attention_fwd(*args)
        torch.cuda.synchronize()
        err = max_err(out, paged_attention_plain(*args), dtype,
                      f"paged {what} {dtype}")
        errs[dtype].append(err)
        return err

    mixed = [1, 16, 17, 255, 256, 511, 592, 600]   # page and tile edges
    for dt, d, g, t in itertools.product((torch.bfloat16, torch.float32),
                                         (32, 64, 128), (1, 7, 8, 32),
                                         (8, 16, 64)):
        err = check(inputs(mixed, dt, h=g * sv["hkv"], d=d, t=t), dt,
                    f"D={d} G={g} T={t}")
        log("kernels", kernel="paged_attention", dtype=str(dt), D=d, G=g,
            T=t, lengths=mixed, max_abs_err=f"{err:.3e}")
    # 16-token pages, 37 columns: 10 spans of 64 tokens, all of these in
    # the first; a length of 0 must give a row of zeros
    short = [0, 1, 16, 17, 40, 63, 64, 5]
    for dt in (torch.bfloat16, torch.float32):
        args = inputs(short, dt, extra_cols=37 - 4)
        err = check(args, dt, "first span only")
        if paged_attention_fwd(*args)[0].abs().max().item() != 0:
            raise AssertionError("paged: a length of 0 gave a nonzero row")
        log("kernels", kernel="paged_attention", dtype=str(dt),
            case="'first span only'", lengths=short, table_cols=37,
            max_abs_err=f"{err:.3e}")
    # 33 query heads per kv head: refused before any launch, and the
    # launches after it run clean
    try:
        paged_attention_fwd(*inputs([5, 9], torch.bfloat16, h=33, hkv=1))
    except ValueError as e:
        log("kernels", kernel="paged_attention", case="'G=33'",
            refused=repr(str(e)))
    else:
        raise AssertionError("paged: 33 heads per kv head did not raise")
    # pool rows of D + 1 elements, which 16-byte copies cannot read: the
    # call is refused before any launch (this kernel) or agrees with the
    # plain version (a kernel of scalar loads, as a parent tree's under
    # scripts/chip_ab.py), never a wrong answer; the launches after it
    # run clean
    q, k, v, tbl, lens = inputs([5, 9], torch.bfloat16, d=sv["d"] + 1)
    args = (q[..., :-1], k[..., :-1], v[..., :-1], tbl, lens)
    try:
        err = check(args, torch.bfloat16, "unaligned pool")
    except RuntimeError as e:
        if "misaligned" not in str(e):
            raise
        log("kernels", kernel="paged_attention", case="'unaligned pool'",
            refused=repr(str(e)))
    else:
        log("kernels", kernel="paged_attention", case="'unaligned pool'",
            refused=None, max_abs_err=f"{err:.3e}")

    # a mid-run decode step of the serve phase: the base request and 7
    # forks, 15 tokens in; pages scattered over a 2048-page pool, then the
    # serve run's table (31 system-prompt pages shared by all 8 rows, each
    # fork's copy-on-write page and suffix its own)
    lens = [SERVE_PROMPT + 16] + [SERVE_PROMPT + SERVE_SUFFIX + 16] \
        * SERVE_FORKS
    n_shared = SERVE_PROMPT // sv["t"]
    row = 2 * sv["hkv"] * sv["d"] * 2        # K and V bytes of one token

    def bytes_of(ntok):                       # K/V once, q, out, table, lens
        return (ntok * row + 2 * 2 * len(lens) * sv["h"] * sv["d"]
                + 4 * len(lens) * (-(-max(lens) // sv["t"]) + 1)
                + 4 * len(lens))

    flops = 4 * sv["d"] * sv["h"] * sum(lens)
    timings = {}
    for what, shared in (("serve", 0), ("shared", n_shared)):
        args = inputs(lens, torch.bfloat16, pages=sv["pages"], shared=shared)
        err = check(args, torch.bfloat16, f"{what} lengths")
        ms = cuda_ms_turns({
            "kernel": lambda: paged_attention_fwd(*args),
            "plain": lambda: paged_attention_plain(*args)})
        t_bound, by = bound(bytes_of(sum(lens)), flops,
                            PEAK_FLOPS[torch.bfloat16])
        unique = sum(lens) - (len(lens) - 1) * n_shared * sv["t"] \
            if shared else sum(lens)
        t_unique, _ = bound(bytes_of(unique), flops,
                            PEAK_FLOPS[torch.bfloat16])
        host = host_us(lambda: paged_attention_fwd(*args))
        timings[what] = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                         "bound_ms": t_bound, "bound_by": by,
                         "bound_ms_unique_pages": t_unique,
                         "unique_tokens": unique, "host_us": host}
        log("kernels", kernel="paged_attention", timing=what,
            ms=f"{ms['kernel']:.5f}", plain_ms=f"{ms['plain']:.5f}",
            bound_ms=f"{t_bound:.7f}", bound_ms_unique=f"{t_unique:.7f}",
            host_us=f"{host:.3f}", max_abs_err=f"{err:.3e}")
    sv_t = timings["serve"]
    return {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:76",
        "max_abs_err": max(errs[torch.bfloat16]),
        "max_abs_err_fp32": max(errs[torch.float32]),
        "ms": sv_t["ms"], "kernel_ms": sv_t["ms"],
        "plain_ms": sv_t["plain_ms"], "bound_ms": sv_t["bound_ms"],
        "bound_by": sv_t["bound_by"], "library_ms": None,
        "shared_prefix": timings["shared"],
        "shape": f"B={len(lens)} H={sv['h']} Hkv={sv['hkv']} D={sv['d']} "
                 f"T={sv['t']} lengths={lens} bf16"}


def ssd_kernel(gen: torch.Generator) -> dict:
    """The SSD-scan kernel against its plain version, in fp32 as the path
    runs it, and its times at zamba2's prefill shape."""
    from repro_torch.kernels.mamba2_scan import ssd_scan_plain
    from repro_torch.kernels.mamba2_scan.kernel import ssd_scan_fwd

    dev = torch.device("cuda")

    def inputs(b, s, h, p, n, *, dt_scale=1.0, a_log=None, s0=False):
        # the op's prologue in the model's [B, S, H, .] layout; the kernel
        # reads the [B, H, S, .] transposed views, as on the path
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        dt = torch.nn.functional.softplus(rnd(b, s, h)) * dt_scale
        a_log = 0.5 * rnd(h) if a_log is None else torch.full(
            (h,), a_log, device=dev)
        xw = rnd(b, s, h, p) * dt[..., None]
        dta = dt * -torch.exp(a_log)
        return (xw.transpose(1, 2), dta.transpose(1, 2), rnd(b, s, n),
                rnd(b, s, n), rnd(b, h, p, n) if s0 else None)

    sv = SSD_SHAPE
    cases = {
        "serving": (dict(b=sv["b"], s=sv["s"], h=sv["h"], p=sv["p"],
                         n=sv["n"]), sv["chunk"], {}),
        "one chunk": (dict(b=2, s=128, h=8, p=64, n=64), 128, {}),
        "S < chunk": (dict(b=2, s=64, h=8, p=64, n=64), 128, {}),
        "smoke sizes": (dict(b=2, s=64, h=8, p=16, n=16), 16, {}),
        "given s0": (dict(b=2, s=256, h=8, p=64, n=64), 128, {"s0": True}),
        # l falls by ~1000 over a chunk: exp(l_i - l_j) above the diagonal
        # would be inf if it were formed before the mask
        "large dt": (dict(b=1, s=256, h=8, p=64, n=64), 128,
                     {"dt_scale": 4.0, "a_log": 1.0}),
    }
    errs = []
    for what, (shape, chunk, extra) in cases.items():
        xw, dta, b, c, s0 = inputs(**shape, **extra)
        y, sf = ssd_scan_fwd(xw, dta, b, c, chunk=chunk, s0=s0)
        torch.cuda.synchronize()
        yr, sr = ssd_scan_plain(xw, dta, b, c, chunk=chunk, s0=s0)
        if what == "large dt" and -dta.sum(dim=-1).max() < 89:
            raise AssertionError("the large-dt case does not overflow")
        err = max(max_err(y, yr, torch.float32, f"ssd {what} y", SSD_TOL),
                  max_err(sf, sr, torch.float32, f"ssd {what} state",
                          SSD_TOL))
        errs.append(err)
        log("kernels", kernel="mamba2_scan", case=repr(what), chunk=chunk,
            **shape, max_abs_err=f"{err:.3e}",
            max_abs_y=f"{yr.abs().max().item():.3e}")
        del y, sf, yr, sr

    # a 256-step chunk holds G = C·Bᵀ [256, 256] in fp32, more shared
    # memory than a block may have: the launch returns the CUDA error, and
    # the launches after it (the timing below) must not see it again
    xw, dta, b, c, _ = inputs(1, 256, 2, 64, 64)
    try:
        ssd_scan_fwd(xw, dta, b, c, chunk=256)
    except RuntimeError as e:
        log("kernels", kernel="mamba2_scan", case="'chunk 256'",
            refused=repr(str(e)))
    else:
        raise AssertionError("ssd chunk 256 did not fail to launch")

    b, s, h, p, n, q = (sv[k] for k in ("b", "s", "h", "p", "n", "chunk"))
    xw, dta, bb, cc, _ = inputs(b, s, h, p, n)
    ms = cuda_ms_turns({
        "kernel": lambda: ssd_scan_fwd(xw, dta, bb, cc, chunk=q),
        "plain": lambda: ssd_scan_plain(xw, dta, bb, cc, chunk=q)}, 6)
    # each input read once and each output written once, fp32.  The
    # operations, the lesser of two ways to the same result: the chunked
    # form at Q (C·Bᵀ's lower triangle once per batch row and chunk, since
    # it is the same for every head; per head M·XW's lower triangle and the
    # Q×P×N products C·Sᵀ and Σ_j XW_j ⊗ B_j), or the token recurrence
    # (S ← decay·S + XW_t ⊗ B_t, then C_t·S: 5·P·N per token and head),
    # at the rate of fp32-accurate products on the tensor cores
    nbytes = 4 * (2 * xw.numel() + dta.numel() + bb.numel() + cc.numel()
                  + b * h * p * n)
    chunked = b * (s // q) * (q * (q + 1) * n
                              + h * (q * (q + 1) * p + 4 * q * p * n))
    recurrent = 5 * b * s * h * p * n
    flops = min(chunked, recurrent)
    ssd_bound, ssd_by = bound(nbytes, flops, SPLIT_TF32_FLOPS)
    log("kernels", kernel="mamba2_scan",
        bytes_ms=f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f}",
        ops_ms=f"{flops / SPLIT_TF32_FLOPS * 1e3:.5f}",
        ops_ms_fp32_simt=f"{flops / PEAK_FLOPS[torch.float32] * 1e3:.5f}")
    return {
        "name": "mamba2_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/mamba2_scan.cu",
        "replaces": "src/repro/kernels/mamba2_scan/kernel.py:72",
        "max_abs_err": max(errs), "ms": ms["kernel"],
        "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
        "bound_ms": ssd_bound, "bound_by": ssd_by,
        "library_ms": None, "bytes": nbytes, "flops": flops,
        "flops_chunked": chunked, "flops_recurrent": recurrent,
        "shape": f"B={b} S={s} H={h} P={p} N={n} chunk={q} fp32"}


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
    time in the window, with the port's own kernels always among them,
    each with its share of the busy time."""
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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for i, (kname, (n, t)) in enumerate(ranked):
        # the twelve costliest kernels, and every kernel of the port's own
        if i < 12 or any(k in kname for k in PORT_KERNELS):
            print(f"[profile] {name}: {t:9.3f} ms {n:5d}x "
                  f"{t / busy_ms:7.2%} {kname[:90]}")


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


# ---------------------------------------------------------------- phase 5
def phase_zamba2_parity(gen: torch.Generator) -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.mamba2_scan import kernel as sk
    from repro_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("zamba2-1.2b").replace(n_layers=7,
                                            compute_dtype="float32",
                                            attn_impl="pallas")
    model = get_model(cfg)
    params = model.init(gen, device="cuda")
    b, s = 2, 256
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab, (b, s))).cuda()
    sk.launches = fk.launches = 0
    with torch.no_grad():
        full = model.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
        if (sk.launches, fk.launches) != (7, 1):
            raise AssertionError(f"zamba2 forward launched ssd "
                                 f"{sk.launches}, flash {fk.launches}")
        cache = model.init_cache(b, s)
        steps = []
        for t in range(s):
            logits, cache = model.decode_step(
                params, cache, {"tokens": tokens[:, t:t + 1],
                                "pos": torch.full((b,), t, dtype=torch.int32,
                                                  device="cuda")})
            steps.append(logits[:, 0])
        stepped = torch.stack(steps, dim=1)
        torch.cuda.synchronize()
    if (sk.launches, fk.launches) != (7, 1):
        raise AssertionError("the stepped decode launched a kernel")
    err = max_err(full, stepped, torch.float32,
                  "zamba2 forward vs stepped decode", SSD_TOL)
    same = (full.argmax(-1) == stepped.argmax(-1)).float().mean().item()
    if same != 1.0:
        raise AssertionError(f"zamba2 greedy tokens differ: {same:.4f} "
                             "of positions agree")
    log("zamba2_parity", arch="zamba2-1.2b", layers=cfg.n_layers,
        attn_sites=1, dtype="float32", batch=b, seq=s,
        max_abs_err=f"{err:.3e}",
        max_abs_logit=f"{full.abs().max().item():.3e}", tokens_equal=True)
    del params, cache, full, stepped
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 6
def phase_zamba2_serve(gen: torch.Generator, profile: bool = False) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.mamba2_scan import kernel as sk
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_map
    from repro_torch.train import make_prefill_step, make_serve_step

    cfg = get_config("zamba2-1.2b").replace(attn_impl="pallas")
    model = get_model(cfg)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    # fp32 init, then the serving copy in the compute dtype
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      model.init(gen, device="cuda"))
    gc.collect()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    rng = np.random.RandomState(0)
    n_sites = 6

    def batch(b, s):
        return torch.from_numpy(rng.randint(0, cfg.vocab, (b, s))).cuda()

    torch.cuda.reset_peak_memory_stats()
    sk.launches = fk.launches = 0
    prefill_ms = []
    with torch.no_grad():
        for i in range(Z_PREFILLS):
            tokens = batch(Z_PREFILL_B, Z_PREFILL_S)
            t0 = time.perf_counter()
            nxt = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            if (sk.launches, fk.launches) != (cfg.n_layers * (i + 1),
                                              n_sites * (i + 1)):
                raise AssertionError(f"prefill {i}: ssd {sk.launches}, "
                                     f"flash {fk.launches} launches")
            if nxt.shape != (Z_PREFILL_B,) or not bool(
                    ((nxt >= 0) & (nxt < cfg.vocab)).all()):
                raise AssertionError(f"prefill tokens {nxt.tolist()}")
    prefill_peak = torch.cuda.max_memory_allocated()
    launches = {"mamba2_scan": sk.launches, "flash_attention": fk.launches}

    torch.cuda.reset_peak_memory_stats()
    prompts = batch(Z_DECODE_B, Z_PROMPT)
    cache = model.init_cache(Z_DECODE_B, Z_CACHE_LEN)
    step_ms, out = [], []
    toks = prompts[:, :1]
    with torch.no_grad():
        for t in range(Z_PROMPT + Z_NEW - 1):
            pos = torch.full((Z_DECODE_B,), t, dtype=torch.int32,
                             device="cuda")
            t0 = time.perf_counter()
            nxt, cache = serve(params, cache, {"tokens": toks, "pos": pos})
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if t >= Z_PROMPT - 1:
                out.append(nxt)
            toks = (prompts[:, t + 1:t + 2] if t + 1 < Z_PROMPT
                    else nxt[:, None].long())
    decode_peak = torch.cuda.max_memory_allocated()
    if sk.launches != launches["mamba2_scan"]:
        raise AssertionError("decode launched the SSD-scan kernel")
    gen_toks = torch.stack(out, dim=1)
    if gen_toks.shape != (Z_DECODE_B, Z_NEW) or not bool(
            ((gen_toks >= 0) & (gen_toks < cfg.vocab)).all()):
        raise AssertionError(f"decode tokens {gen_toks.tolist()}")
    for name in ("ssm", "conv"):
        if not torch.isfinite(cache[name]).all():
            raise AssertionError(f"non-finite {name} cache")
    for name in ("k", "v"):
        if not torch.isfinite(cache["attn"][name]).all():
            raise AssertionError(f"non-finite attention {name} cache")
    if cache["attn"]["key_pos"].max().item() != Z_PROMPT + Z_NEW - 2:
        raise AssertionError("ring cache key positions")

    decode_s = sum(step_ms) / 1e3
    # tokens/s of the prefills after the first, which carries the warm-up
    prefill_tps = Z_PREFILL_B * Z_PREFILL_S * (Z_PREFILLS - 1) \
        / (sum(prefill_ms[1:]) / 1e3)
    log("zamba2_serve", arch="zamba2-1.2b", layers=cfg.n_layers,
        attn_sites=n_sites, d_model=cfg.d_model, dtype=cfg.compute_dtype,
        params=model.param_count(),
        prefill_batch=Z_PREFILL_B, prefill_seq=Z_PREFILL_S,
        prefill_ms=[round(x, 3) for x in prefill_ms],
        prefill_tokens_per_s=f"{prefill_tps:.1f}",
        decode_batch=Z_DECODE_B, decode_steps=len(step_ms),
        cache_len=cache["attn"]["k"].shape[2],
        decode_ms_per_step=f"{np.mean(step_ms):.3f}",
        decode_ms_median=f"{np.median(step_ms):.3f}",
        decode_tokens_per_s=f"{Z_DECODE_B * len(step_ms) / decode_s:.1f}",
        setup_s=f"{setup_s:.3f}", setup_peak_gb=f"{setup_peak / 1e9:.3f}",
        prefill_peak_gb=f"{prefill_peak / 1e9:.3f}",
        decode_peak_gb=f"{decode_peak / 1e9:.3f}", launches=launches)
    if profile:
        # outside the counted run: one prefill, then 8 decode steps
        tokens = batch(Z_PREFILL_B, Z_PREFILL_S)
        with torch.no_grad():
            profile_window("zamba2 prefill x1",
                           lambda: prefill(params, {"tokens": tokens}))
            profile_window("zamba2 decode x8", lambda: [
                serve(params, cache, {"tokens": toks, "pos": pos})
                for _ in range(8)])
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card; this script runs on the "
              "GPU only", file=sys.stderr)
        return 1
    # with no arguments every phase runs and the result lines are printed;
    # naming phases (kernels, parity, serve, zamba2_parity, zamba2_serve,
    # profile) runs just those, to debug or to trace a serve phase; profile
    # alone traces the qwen2-7b serve phase
    phases = sys.argv[1:] or ["kernels", "parity", "serve", "zamba2_parity",
                              "zamba2_serve"]
    profile = "profile" in phases

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    card = phase_card()
    # each path's launches, counted from 0 just before it is driven
    launches = {}
    if "kernels" in phases:
        kernels = phase_kernels(gen(2))
    if "parity" in phases:
        phase_parity(gen(1))
    if "serve" in phases or (profile and "zamba2_serve" not in phases):
        launches["qwen2-7b serve"] = phase_serve(gen(0), profile=profile)
    if "zamba2_parity" in phases:
        phase_zamba2_parity(gen(3))
    if "zamba2_serve" in phases:
        launches["zamba2-1.2b serve"] = phase_zamba2_serve(gen(0), profile)
    if sys.argv[1:]:
        return 0
    for name, kern in kernels.items():
        by_path = {path: counts[name] for path, counts in launches.items()
                   if name in counts}
        kern["launches"] = sum(by_path.values())
        kern["launches_by_path"] = by_path
        if not kern["launches"]:
            raise AssertionError(f"{name} was not launched on its path")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
