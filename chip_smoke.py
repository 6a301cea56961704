"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py                        # every phase, the result
  python3 chip_smoke.py zamba2_serve profile   # named phases only, traced
  python3 chip_smoke.py train_parity train     # the training phases
  python3 chip_smoke.py dense_parity moe_parity moe_serve   # dense + MoE
  python3 chip_smoke.py whisper_parity whisper_serve xlstm_parity xlstm_serve
  python3 chip_smoke.py xlstm_train            # xLSTM training at 4096

Phases, one line each; a failing phase raises and nothing catches it:

1. card: the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/csrc`` (one nvcc per source, all started together),
   with each kernel's registers and spills and its count of tensor-core
   SASS instructions (HGMMA: wgmma, HMMA: mma.sync) where a disassembler
   is found.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the serving and training paths (flash at qwen2-7b's and
   zamba2's prefill shapes, at smollm-360m's training microbatch, 15
   heads over 5, at head dim 32, at olmoe-1b-7b's prefill, at
   command-r-35b's 64 heads over 8, at llava-next-34b's 576 patches
   and 64 text tokens over 56 heads and at mistral-large-123b's 96 heads
   over 8, at 2048 tokens and at the engine_parity prompts' lengths, and
   non-causal at whisper-medium's encoder shape, 1500 frames at B=1 and
   B=8, 16 heads over 16 and over 4, and 30 frames; paged
   at bf16 and fp32, head dims 32/64/128, 1/7/8/12/32 query heads per kv
   head and 8/16/64-token pages, a batch whose table leaves every span
   but the first empty, and 33 heads per kv head and a pool view that
   16-byte copies cannot read, which must raise; for the SSD scan also
   one chunk, a sequence shorter than the chunk, the smoke sizes, a given initial state
   and a dt large enough that an unmasked decay overflows; a chunk too
   large for shared memory must fail to launch), and the times of kernel,
   plain version and (for flash) the PyTorch library call, with CUDA
   events, kernel and its yardstick timed in turns; paged also with the
   serve run's shared-prefix table; the flash backward kernel (bf16 on
   the card) against the plain fp32 recompute at the training shape, head
   dims 32 and 128, non-causal, with windows and with Sq != Skv, each
   call counted; one backward call at the training shape against the
   library call's backward and the plain recompute, and forward and
   backward of the op against the library call's; the flash kernels at
   latent attention's head sizes (q/k 192, v 128) at moonlight-16b-a3b's
   training microbatch (B=2 S=4096 H=16) and ragged, non-causal and
   Sq != Skv shapes, forward and gradients checked, forward and one
   backward call timed.
3. parity: qwen2-7b at full width, 2 layers, fp32 (TF32 off): the engine's
   greedy tokens (kernels) equal teacher-forced greedy tokens from the
   port's kernel-free ``dense.forward``.
3b. dense_parity: the same check for command-r-35b (parallel blocks) and
   mistral-large-123b at full width, 2 layers, fp32, 16 new tokens; and
   llava-next-34b's ``forward`` over 576 patch embeddings of width 1024
   and 64 text tokens through flash equals its einsum path within 2e-3.
   Each model is freed before the next; each one's peak memory is printed.
4. serve: qwen2-7b at full width (28 layers), bf16, random weights from
   seed 0; a 500-token system prompt and 7 forks of it with 64-token
   suffixes, 32 new tokens each.  The launch counts of both kernels must
   match the path.
5. zamba2_parity: zamba2-1.2b at full width, 7 layers (one group, its
   shared-attention site, one more layer), fp32 (TF32 off), B=2, S=256:
   the logits of ``forward`` (SSD-scan and flash kernels) equal those of
   ``decode_step`` stepped token by token from ``init_cache`` (no kernel)
   within 2e-3, and so do their greedy tokens.
5b. moe_parity: olmoe-1b-7b and granite-moe-3b-a800m at full width, 2
   layers, fp32, capacity factor E/k (dropless), B=2, S=256: ``forward``
   (flash) equals ``decode_step`` stepped token by token (no kernel)
   within 2e-3, and so do the greedy tokens; the share of routing choices
   the two agree on and the smallest top-k margin are printed.
5c. mla_parity: moonlight-16b-a3b as its benchmark cell holds it (14
   layers, experts 0-7 of 64, vocab 20,480), weights from the
   benchmark's draw: the bf16 ``forward`` (flash at q/k 192, v 128) on
   2 × 4096 tokens against the fp32 reference of
   ``bench/reference/mla_moe.py``: the logits' gap and, per expert layer,
   the share of choices routed differently.
6. zamba2_serve: zamba2-1.2b at full width and depth (38 layers), bf16,
   random weights from seed 0: ``make_prefill_step`` on 4 prompts of 4096
   tokens (38 SSD-scan and 6 flash launches per call), then
   ``make_serve_step`` at batch 8 against ``init_cache(8, 4096)``: 128
   teacher-forced prompt tokens, then 64 greedy ones (no SSD launch).
6b. moe_serve: olmoe-1b-7b as published (16 layers, 6.92 B params), bf16,
   random weights from seed 0: ``make_prefill_step`` on 4 prompts of 4096
   tokens (16 flash launches per call), then ``make_serve_step`` at batch
   8 against ``init_cache(8, 4096)``: 128 teacher-forced prompt tokens,
   then 64 greedy ones (no flash launch); the share of expert choices
   that capacity drops, in prefill and in decode.
6c. whisper_parity: whisper-medium at full width, 2 encoder and 2 decoder
   layers, fp32 (TF32 off), B=2, 1500 frames, 64 tokens: ``forward``
   (flash: the encoder's non-causal self-attention, the decoder's causal)
   equals ``decode_step`` stepped token by token against the cross K/V of
   ``make_cross_kv`` (no kernel) within 2e-3, with equal greedy tokens;
   ``encode`` through flash equals the einsum path's within 2e-3.
6d. whisper_serve: whisper-medium as published (24 + 24 layers, 762.8 M
   params), bf16: ``encode`` of 8 × 1500 frames (30 s of audio each) and
   ``make_cross_kv``, twice (24 flash launches each); then a 4-token
   decoder prompt teacher-forced and 60 greedy tokens through
   ``make_serve_step`` against ``init_cache(8, 448)`` (no flash launch).
6e. xlstm_parity: xlstm-1.3b at full width (d 2048, 4 heads, dk 256 and
   dv 512 per head), one group (7 mLSTM, 1 sLSTM), fp32, B=2, S=256:
   ``forward`` equals stepped ``decode_step`` within 2e-3, with equal
   greedy tokens; ``mlstm_chunked`` equals a loop of ``mlstm_step`` at
   the full head dims within 2e-4 / 2e-3.
6f. xlstm_serve: xlstm-1.3b as published (48 layers, 1.13 B params),
   bf16: ``make_prefill_step`` on 2 calls of 4 × 2048 tokens and the
   device ops of one more; then ``make_serve_step`` at batch 8, 128
   teacher-forced and 64 greedy tokens.  No kernel runs on this path.
6g. xlstm_train: xlstm-1.3b at full width, one group (7 mLSTM, 1 sLSTM),
   fp32 params, bf16 compute, remat "dots", AdamW, batch 1 × 4096: a
   warm-up step and two timed steps, the device busy ms, idle share and
   op count of one more step from a torch.profiler window, the peak
   memory, and the cost counter's bytes and FLOPs for the same step on
   meta tensors.  The loss, grad norm and params must stay finite.  No
   kernel runs on this path.
7. train_parity: fp32, TF32 off, B=2, S=256: one train step's loss, grad
   norm and every gradient through the kernels and without them, from one
   state: smollm-360m at full width, 2 layers, flash kernel against the
   einsum path; zamba2-1.2b at full width, 7 layers, and olmoe-1b-7b at
   full width, 2 layers (loss = ce + the router's aux loss), through the
   kernels against the same step on the CPU (plain versions);
   whisper-medium, 2 + 2 layers over 1500 frames and 64 tokens, flash
   against the einsum path and the card against the CPU; xlstm-1.3b, one
   group at remat "dots", the card against the CPU.
8. train: smollm-360m as published (32 layers, 361.8 M params), fp32
   params, bf16 compute, flash kernel; global batch 8 × 2048 tokens in 2
   microbatches, AdamW, random init from seed 0, the learnable Markov
   stream of ``examples/train_lm.py`` as a WTF token shard on a 4-server,
   2-replica cluster in a temporary directory.  20 steps through the
   port's ``Trainer`` with a checkpoint at 20, then a fresh trainer
   restores step 20 (state bit for bit, data cursor) and trains to 24.
   Flash launches, forward and backward kernel each, must be 32 × 2 × 24;
   the loss must fall.
9. pod_sync: two processes share the card over gloo, one pod each of a
   ("pod",) mesh of 2; each trains smollm-360m as the train phase does
   (batch 8 × 2048 in 2 microbatches, its own WTF cluster, host ``rank``
   of a pipeline of global batch 16) for 4 steps, with the int8
   ``make_pod_sync`` every 2.  After each sync both ranks' params must be
   bit-identical and every leaf within one int8 step of the fp32 mean of
   the pre-sync params; each process must launch the flash forward and
   backward kernels 32 × 2 × 4 times each.
   The sync's ms, the int8 bytes per sync, the peak memory per process
   and whether gloo's all-gather takes CUDA tensors are printed.
10. dryrun: ``repro_torch.launch.dryrun`` in subprocesses (no card, a
   fake process group), all started together: smollm-360m × train_4k and
   qwen2-7b × prefill_32k on the (16, 16) mesh, olmoe-1b-7b × train_4k on
   (16, 16) and (2, 16, 16), and one device at the train phase's shape;
   the H100 roofline terms of each, and the train phase's measured step
   beside the one-device bound.  Each mesh cell is held against the JAX
   package's numbers for it (``scripts/jax_dryrun_reference.json``): at
   most 1.25 × its FLOPs per device, a collective term at most 2 × its
   or under 10 ms, and no view the counter had to replicate.
11. sharded_train: cases 1 and 3 of ``tests/test_torch_sharded_train.py``
   through its worker (``tests/torch_sharded_worker.py``), in 8 gloo
   processes each on the CPU (no card), started beside the dryrun phase:
   olmoe-1b-7b's smoke config in fp32 on a ("data", "model") mesh of
   (2, 4) at batch 4 (prefill, decode and one train step), and its train
   step at batch 16 in 2 microbatches on ("pod", "data", "model") of
   (2, 2, 2), each against the same steps unsharded within 1e-5, with
   equal tokens; the smallest top-k margin met is printed.  It holds the
   sharded MoE block and the accumulated step under this machine's torch.

Run it from the root of a checkout: it imports ``src/`` of the working
directory.  It imports nothing of JAX or of the JAX package ``repro``.
The last line
is ``{"ok": true, "device": {...}}``; before it come the ``kernels`` JSON
line and the card's ``nvidia-smi`` name and power limit.  Exits nonzero,
with no result, where torch sees no CUDA card.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

# the port of the checkout it is run from: its root is the working
# directory
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
KERNEL_LIBS = ["flash_attention", "flash_attention_bwd", "paged_attention",
               "mamba2_scan"]
PORT_KERNELS = ("flash_bf16", "flash_fp32", "flash_bwd", "paged_fwd",
                "paged_merge", "chunk_states", "state_pass", "chunk_outputs")
TRAIN_FLASH_SHAPE = dict(b=4, s=2048, h=15, hkv=5, d=64)  # smollm train
# the flash backward kernel against the fp32 plain recompute: the norm of
# the difference over the reference's norm, and the largest difference over
# the reference's largest entry.  The kernel rounds P and dS to bf16 for
# its products (2^-9 relative each) and adds dQ's tiles in another order
# (fp32); 2e-2 leaves ~5 x room above the 2.5-4.1e-3 that rounding gives
# on an H100
FLASH_BWD_TOL = 2e-2
MOE_FLASH_SHAPE = dict(b=4, s=4096, h=16, hkv=16, d=128)  # olmoe prefill
# moonlight-16b-a3b's training microbatch: latent attention scores over
# 128 + 64 dims (dk) and sums values of 128 (dv)
MLA_FLASH_SHAPE = dict(b=2, s=4096, h=16, hkv=16, dk=192, dv=128)
# its benchmark configuration (bench/configs/), which mla_parity runs
MLA_CONFIG = "moonlight-16b-a3b.ep8-pp2"
# mla_parity's fp32 forward against the reference: the two sum in other
# orders, so a choice whose s + b ties the next to fp32 rounding routes
# differently in a later layer (on an H100: 1e-4 of the choices or fewer,
# 3.2e-3 of the logits' norm, where bf16 reads 8.6e-2); a fault of the
# model's code moves every token
MLA_FP32_GAP = 1e-2
# command-r at a 2048-token prompt; llava: 576 patches + 64 text tokens
CMDR_FLASH_SHAPE = dict(b=1, s=2048, h=64, hkv=8, d=128)
LLAVA_PATCHES, LLAVA_TEXT = 576, 64
# mistral-large-123b's heads (12 query heads per kv head) at a 2048-token
# prompt
MISTRAL_FLASH_SHAPE = dict(b=1, s=2048, h=96, hkv=8, d=128)
# engine_parity's prompts: a base, a fork of it and another prompt
PARITY_PROMPTS = (40, 45, 23)
LLAVA_FLASH_SHAPE = dict(b=1, s=LLAVA_PATCHES + LLAVA_TEXT, h=56, hkv=8,
                         d=128)
# whisper-medium's encoder self-attention (non-causal) over 30 s of audio
WHISPER_FLASH_SHAPE = dict(b=8, s=1500, h=16, hkv=16, d=64)
SERVE_PROMPT, SERVE_SUFFIX, SERVE_FORKS, SERVE_NEW = 500, 64, 7, 32
# the long-prompt serve traffic of zamba2-1.2b and olmoe-1b-7b: 3 prefill
# calls of 4 × 4096 tokens, then batch-8 decode against a 4096-token cache
# (128 prompt tokens teacher-forced, then 64 greedy ones)
LONG_SERVE = types.SimpleNamespace(prefill_b=4, prefill_s=4096, prefills=3,
                                   decode_b=8, cache_len=4096, prompt=128,
                                   new=64)
# whisper-medium serving: 8 clips of 30 s (1500 frames) encoded, twice;
# decode at batch 8 against its 448-token decoder context, a 4-token
# prompt teacher-forced, then 60 greedy tokens.  whisper_parity decodes 64
WHISPER_SERVE = types.SimpleNamespace(batch=8, encodes=2, context=448,
                                      prompt=4, new=60)
WHISPER_TOKENS = 64
# xlstm-1.3b serving: 2 prefill calls of 4 × 2048 tokens (its training
# context), then batch-8 decode, 128 prompt tokens teacher-forced and 64
# greedy ones
XLSTM_SERVE = types.SimpleNamespace(prefill_b=4, prefill_s=2048, prefills=2,
                                    decode_b=8, prompt=128, new=64)
# xlstm-1.3b training at train_4k's length: one group (8 layers) at full
# width, batch 1 × 4096, one warm-up step and two timed
XLSTM_TRAIN = types.SimpleNamespace(b=1, s=4096, warmup=1, steps=2)
# smollm-360m training: global batch 8 of 2048 tokens in 2 microbatches,
# 20 steps, a checkpoint at 20, a restart that trains on to 24
TRAIN_B, TRAIN_S, TRAIN_ACCUM = 8, 2048, 2
TRAIN_STEPS, TRAIN_RESTART_STEPS, TRAIN_WARMUP = 20, 24, 2
# train_parity: each gradient leaf within this share of its largest
# entry.  smollm: the fp32 flash kernel against the einsum path (both
# backwards are the same plain recompute, so only the forward's 2e-5 moves
# them); zamba2: the SSD kernel (split-TF32 products) against the CPU, at
# the SSD tolerance
# olmoe: the card's flash kernel and index_add order against the CPU, held
# to zamba2's tolerance
# whisper (flash against einsum, and the card against the CPU) and xlstm
# (the card against the CPU) are held to the same tolerance
# xlstm train_parity: a position whose normaliser margin differs in sign
# between the card and the CPU must lie within this share of its floor
# (the forward's card-vs-CPU rounding is ~1e-5); at most this many batches
# are drawn to find one where no position changes side
XLSTM_TIE, XLSTM_BATCHES = 1e-4, 3
# pod_sync: two processes (one pod each) share the card over gloo, each
# training smollm-360m as the train phase does on its half of a global
# batch of 16; the int8 parameter average runs every POD_SYNC_EVERY steps
POD_RANKS, POD_STEPS, POD_SYNC_EVERY = 2, 4, 2
# the train phase's measured median step, for the dryrun phase
TRAIN_RESULT: dict = {}
# the dryrun phase's cells by mesh, each held against the JAX package's
# dry-run of the same cell (FLOPs per device from its HLO walk, and the
# collective term `report.terms` gives its collectives), as
# `scripts/torch_dryrun_vs_jax.py --write-reference` wrote them into
# DRYRUN_REFERENCE; the port's per-device counts must stay within
# `report.within_reference`
DRYRUN_CELLS = {"pod": [("smollm-360m", "train_4k"),
                        ("qwen2-7b", "prefill_32k"),
                        ("olmoe-1b-7b", "train_4k")],
                "multipod": [("olmoe-1b-7b", "train_4k")]}
DRYRUN_REFERENCE = os.path.join("scripts", "jax_dryrun_reference.json")
GRAD_TOL = {"smollm-360m": 1e-4, "zamba2-1.2b": SSD_TOL,
            "olmoe-1b-7b": SSD_TOL, "whisper-medium": SSD_TOL,
            "xlstm-1.3b": SSD_TOL}


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

    def flash_case(b, s, h, hkv, d, dt, window, causal=True):
        q, k, v = qkv(b, s, h, hkv, d, dt)
        out = flash_attention_fwd(q, k, v, causal=causal,
                                  sliding_window=window)
        torch.cuda.synchronize()
        ref = attention_plain(q, k, v, causal=causal, sliding_window=window)
        err = max_err(out, ref, dt, f"flash B={b} S={s} H={h} D={d} {dt} "
                                    f"window={window} causal={causal}")
        if dt == torch.bfloat16:
            flash_errs.append(err)
        log("kernels", kernel="flash_attention", B=b, S=s, H=h, Hkv=hkv, D=d,
            dtype=str(dt), window=window, causal=causal,
            max_abs_err=f"{err:.3e}")
        del q, k, v, out, ref

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
    ts = TRAIN_FLASH_SHAPE                        # 15 heads, GQA 3:1
    for dt in (torch.bfloat16, torch.float32):
        flash_case(ts["b"], ts["s"], ts["h"], ts["hkv"], ts["d"], dt, None)
    # olmoe's prefill (no grouping at D=128), command-r's, llava's and
    # mistral-large's heads; fp32 as dense_parity runs them; mistral's
    # 12-head groups also at the engine_parity prompts' lengths
    new_shapes = (MOE_FLASH_SHAPE, CMDR_FLASH_SHAPE, LLAVA_FLASH_SHAPE,
                  MISTRAL_FLASH_SHAPE)
    for sh in new_shapes:
        flash_case(sh["b"], sh["s"], sh["h"], sh["hkv"], sh["d"],
                   torch.bfloat16, None)
    for sh in new_shapes[1:]:
        flash_case(sh["b"], sh["s"], sh["h"], sh["hkv"], sh["d"],
                   torch.float32, None)
    ms = MISTRAL_FLASH_SHAPE
    for s_len in PARITY_PROMPTS:
        for dt in (torch.bfloat16, torch.float32):
            flash_case(ms["b"], s_len, ms["h"], ms["hkv"], ms["d"], dt, None)
    # the non-causal branch (whisper's encoder): 1500 frames, a partial last
    # kv tile and no diagonal; at B=1 and B=8, grouped 16 over 4, and the
    # smoke encoder's 30 frames, below one tile
    ws = WHISPER_FLASH_SHAPE
    for dt in (torch.bfloat16, torch.float32):
        for b in (1, ws["b"]):
            flash_case(b, ws["s"], ws["h"], ws["hkv"], ws["d"], dt, None,
                       causal=False)
        flash_case(1, ws["s"], ws["h"], 4, ws["d"], dt, None, causal=False)
        flash_case(2, 30, ws["h"], ws["hkv"], ws["d"], dt, None,
                   causal=False)

    def flash_times(b, s, h, hkv, d, what, causal=True):
        """Kernel and library call in turns, plain version alone, at one
        bf16 shape with contiguous inputs; bound from the shape."""
        q, k, v = (t.contiguous() for t in qkv(b, s, h, hkv, d,
                                                 torch.bfloat16))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fns = {"kernel": lambda: flash_attention_fwd(q, k, v, causal=causal),
               "library": lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=True)}
        try:
            fns["library"]()
        except TypeError:       # a PyTorch without enable_gqa (< 2.5)
            del fns["library"]
        ms = cuda_ms_turns(fns)
        plain = cuda_ms(lambda: attention_plain(q, k, v, causal=causal), 5)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        # QK^T and PV, 2 FLOPs per multiply-add each, over the visible keys
        flops = 4 * d * b * h * (s * (s + 1) / 2 if causal else s * s)
        t_bound, by = bound(nbytes, flops, PEAK_FLOPS[torch.bfloat16])
        del q, k, v, qt, kt, vt
        kind = "causal" if causal else "non-causal"
        return {"shape": f"B={b} S={s} H={h} Hkv={hkv} D={d} {kind} bf16",
                "path": what, "ms": ms["kernel"], "kernel_ms": ms["kernel"],
                "plain_ms": plain, "library_ms": ms.get("library"),
                "bound_ms": t_bound, "bound_by": by, "bytes": nbytes,
                "flops": flops}

    # timing at the forks' prefill shape (7 of qwen2-7b's 8 prefills), at
    # zamba2-1.2b's, at smollm-360m's training microbatch, at olmoe-1b-7b's
    # prefill, at command-r-35b's and mistral-large-123b's heads over a
    # 2048-token prompt and at llava-next-34b's image and prompt
    s = SERVE_PROMPT + SERVE_SUFFIX
    flash_shapes = [
        flash_times(fs["b"], s, fs["h"], fs["hkv"], fs["d"],
                    "qwen2-7b serve"),
        flash_times(zs["b"], zs["s"], zs["h"], zs["hkv"], zs["d"],
                    "zamba2-1.2b serve"),
        flash_times(ts["b"], ts["s"], ts["h"], ts["hkv"], ts["d"],
                    "smollm-360m train")]
    for sh, what in zip(new_shapes, ("olmoe-1b-7b serve",
                                     "command-r-35b dense_parity",
                                     "llava-next-34b dense_parity",
                                     "mistral-large-123b dense_parity")):
        flash_shapes.append(flash_times(sh["b"], sh["s"], sh["h"],
                                        sh["hkv"], sh["d"], what))
    flash_shapes.append(flash_times(ws["b"], ws["s"], ws["h"], ws["hkv"],
                                    ws["d"], "whisper-medium encode",
                                    causal=False))
    for sh in flash_shapes:
        log("kernels", kernel="flash_attention", **{
            k: sh[k] for k in ("path", "ms", "plain_ms", "library_ms",
                               "bound_ms", "bound_by")})

    train_fb = flash_train_times(gen)
    log("kernels", kernel="flash_attention", **train_fb)
    flash_shapes[2].update(train_fb)
    mla = flash_mla_times(gen)

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
        "flash_attention_bwd": {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "none (the JAX op differentiates its plain version)",
            "max_rel_err": train_fb["bwd_max_rel_err"],
            "ms": train_fb["bwd_ms"], "plain_ms": train_fb["bwd_plain_ms"],
            "library_ms": train_fb["bwd_library_ms"],
            "bound_ms": train_fb["bwd_bound_ms"],
            "bound_by": train_fb["bwd_bound_by"],
            "shape": f"B={ts['b']} S={ts['s']} H={ts['h']} Hkv={ts['hkv']} "
                     f"D={ts['d']} causal bf16"},
    }
    # the (192, 128) instantiations are rows of the two kernels
    flash_shapes.append(mla["fwd"])
    kernels["flash_attention_bwd"]["mla"] = mla["bwd"]
    kernels["paged_attention"] = paged_kernel(gen)
    kernels["mamba2_scan"] = ssd_kernel(gen)
    for kern in kernels.values():
        log("kernels", **{k: kern[k] for k in
                          ("name", "ms", "plain_ms", "library_ms",
                           "bound_ms", "bound_by")})
    return kernels


def randn_bf16(gen: torch.Generator, b: int, s: int, h: int, d: int):
    return torch.randn((b, s, h, d), generator=gen,
                       device="cuda").to(torch.bfloat16)


def plain_grads(q, k, v, g, **mask) -> tuple:
    """dq, dk, dv by autograd through the plain forward, in fp32."""
    from repro_torch.kernels.flash_attention import attention_plain
    inputs = [t.detach().float().requires_grad_() for t in (q, k, v)]
    out = attention_plain(*inputs, **mask)
    return torch.autograd.grad(out, inputs, g.float())


def flash_bwd_case(gen: torch.Generator, c: dict, fwd_errs=None) -> tuple:
    """One case of the flash op's backward (``c``: b, s (keys), sq
    (queries, default s), h, hkv, d, dv (v's head size, default d),
    causal, window): the op's gradients through the kernels against the
    plain fp32 recompute, each within FLASH_BWD_TOL of the reference's
    norm and of its largest entry.  With ``fwd_errs`` (a list) the
    forward kernel is held against the plain version first, its largest
    difference appended.  Returns (the case's name, the worst relative
    difference)."""
    from repro_torch.kernels.flash_attention import attention_plain, \
        flash_attention
    from repro_torch.kernels.flash_attention import kernel as fk
    mask = dict(causal=c.get("causal", True), sliding_window=c.get("window"))
    sq, dv = c.get("sq", c["s"]), c.get("dv", c["d"])
    q = randn_bf16(gen, c["b"], sq, c["h"], c["d"])
    k, v = randn_bf16(gen, c["b"], c["s"], c["hkv"], c["d"]), \
        randn_bf16(gen, c["b"], c["s"], c["hkv"], dv)
    g = randn_bf16(gen, c["b"], sq, c["h"], dv)
    dims = c["d"] if dv == c["d"] else f"{c['d']}/{dv}"
    what = f"flash bwd B={c['b']} Sq={sq} Skv={c['s']} " \
           f"H={c['h']}/{c['hkv']} D={dims} causal={mask['causal']} " \
           f"window={mask['sliding_window']}"
    if fwd_errs is not None:
        out = fk.flash_attention_fwd(q, k, v, **mask)
        torch.cuda.synchronize()
        fwd_errs.append(max_err(out, attention_plain(q, k, v, **mask),
                                torch.bfloat16, what))
    inputs = [t.requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*inputs, **mask), inputs, g)
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, r in zip(("dq", "dk", "dv"), got,
                          plain_grads(q, k, v, g, **mask)):
        a = a.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what}: non-finite {name}")
        by_norm = ((a - r).norm() / r.norm()).item()
        by_max = ((a - r).abs().max() / r.abs().max()).item()
        if max(by_norm, by_max) > FLASH_BWD_TOL:
            raise AssertionError(
                f"{what}: {name} differs from the plain recompute by "
                f"{by_norm:.3e} of its norm, {by_max:.3e} of its "
                f"largest entry (tolerance {FLASH_BWD_TOL})")
        worst = max(worst, by_norm, by_max)
    return what, worst


def flash_train_times(gen: torch.Generator) -> dict:
    """The flash op's backward: its gradients through the kernel held
    against the plain fp32 recompute at smollm-360m's training microbatch,
    at head dims 32 and 128, non-causal, with a window and with Sq != Skv;
    then, at the microbatch, one backward call of the kernel (from the
    forward's saved log-sum-exp), the library call's backward and the plain
    recompute (called directly: the op's backward before the kernel), and
    forward and backward of the op and of the library call, in turns; and
    the host time of one call of the backward's and the forward's
    wrapper."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as fk

    def rnd(b, s, h, d):
        return randn_bf16(gen, b, s, h, d)

    ts = TRAIN_FLASH_SHAPE
    checks = [dict(ts), dict(b=2, s=300, h=4, hkv=2, d=32),
              dict(b=1, s=576, h=28, hkv=4, d=128),
              dict(b=1, s=1500, h=16, hkv=4, d=64, causal=False),
              dict(b=1, s=576, h=28, hkv=4, d=128, window=128),
              dict(b=2, s=300, h=6, hkv=2, d=64, window=100),
              dict(b=1, s=77, sq=200, h=4, hkv=2, d=64),
              dict(b=1, s=300, sq=77, h=4, hkv=2, d=64, causal=False)]
    launches0, errs = fk.bwd_launches, {}
    for c in checks:
        what, worst = flash_bwd_case(gen, c)
        errs[what] = worst
        log("kernels", kernel="flash_attention_bwd", case=repr(what),
            rel_err=f"{worst:.3e}")
    if fk.bwd_launches - launches0 != len(checks):
        raise AssertionError(f"flash bwd: {fk.bwd_launches - launches0} "
                             f"kernel calls for {len(checks)} backwards")

    b, s, h, hkv, d = (ts[x] for x in ("b", "s", "h", "hkv", "d"))
    q, k, v, g = rnd(b, s, h, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), \
        rnd(b, s, h, d)
    out, lse = fk.flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    gt = g.transpose(1, 2)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    qi, ki, vi = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def op():
        torch.autograd.grad(flash_attention(qi, ki, vi, causal=True),
                            (qi, ki, vi), g)

    def library():
        torch.autograd.grad(F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), (qt, kt, vt), gt)

    launches0 = fk.bwd_launches
    ms = cuda_ms_turns({
        "bwd": lambda: fk.flash_attention_bwd(q, k, v, out, lse, g),
        "library_bwd": lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), gt, retain_graph=True),
        "op": op, "library": library}, rounds=6)
    calls = fk.bwd_launches - launches0
    plain = cuda_ms(lambda: plain_grads(q, k, v, g, causal=True), 5, 1)
    # the five products (QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q, dS·K) over the visible
    # pairs; q, out, dout, dq, k, v, dk and dv once
    flops = 10 * d * b * h * (s * (s + 1) // 2)
    nbytes = 2 * (4 * b * s * h * d + 4 * b * s * hkv * d)
    t_bound, by = bound(nbytes, flops, PEAK_FLOPS[torch.bfloat16])
    if calls != 2 * (2 + 6):     # warm-up and rounds of "bwd" and "op"
        raise AssertionError(f"flash bwd: {calls} kernel calls in the "
                             "timing, not 16")
    # what the host pays for one call of each wrapper, checks, tensor maps
    # and allocations included
    host = {"bwd_host_us": host_us(
                lambda: fk.flash_attention_bwd(q, k, v, out, lse, g), 50),
            "fwd_lse_host_us": host_us(
                lambda: fk.flash_attention_fwd(q, k, v, causal=True,
                                               return_lse=True), 50)}
    return {**host,"fwd_bwd_ms": ms["op"], "library_fwd_bwd_ms": ms["library"],
            "bwd_ms": ms["bwd"], "bwd_library_ms": ms["library_bwd"],
            "bwd_plain_ms": plain, "bwd_bound_ms": t_bound,
            "bwd_bound_by": by, "bwd_flops": flops, "bwd_bytes": nbytes,
            "bwd_max_rel_err": max(errs.values())}


def flash_mla_times(gen: torch.Generator) -> dict:
    """The flash kernels at latent attention's head sizes (q and k 192, v
    128): the forward against the plain version and the op's gradients
    against the plain fp32 recompute, at moonlight-16b-a3b's training
    microbatch and at ragged, non-causal and Sq != Skv shapes; then at the
    microbatch the forward and one backward call timed against the plain
    version and, where it takes the shape, the library call."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.flash_attention import kernel as fk

    ms_ = MLA_FLASH_SHAPE
    dk, dv = ms_["dk"], ms_["dv"]
    checks = [dict(ms_), dict(b=2, s=300, h=4, hkv=4),
              dict(b=1, s=200, h=16, hkv=4, causal=False),
              dict(b=1, s=77, sq=200, h=4, hkv=2),
              dict(b=1, s=300, sq=77, h=4, hkv=2, causal=False)]
    fwd_errs, bwd_errs = [], []
    launches0, bwd0 = fk.launches, fk.bwd_launches
    for c in checks:
        what, worst = flash_bwd_case(gen, {**c, "d": dk, "dv": dv},
                                     fwd_errs)
        bwd_errs.append(worst)
        log("kernels", kernel="flash_attention_mla", case=repr(what),
            fwd_max_abs_err=f"{fwd_errs[-1]:.3e}", bwd_rel_err=f"{worst:.3e}")
    # each check: one forward call, and the op's forward and backward
    if (fk.launches - launches0, fk.bwd_launches - bwd0) != \
            (2 * len(checks), len(checks)):
        raise AssertionError("flash mla: the kernels were not called "
                             "once per check")

    b, s, h, hkv = (ms_[x] for x in ("b", "s", "h", "hkv"))
    q, k, v, g = (randn_bf16(gen, b, s, n, d) for n, d in
                  ((h, dk), (hkv, dk), (hkv, dv), (h, dv)))
    out, lse = fk.flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    fns = {"kernel": lambda: fk.flash_attention_fwd(q, k, v, causal=True),
           "bwd": lambda: fk.flash_attention_bwd(q, k, v, out, lse, g)}
    try:
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        gt = g.transpose(1, 2)
        fns["library"] = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
        fns["library_bwd"] = lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), gt, retain_graph=True)
    except RuntimeError as e:       # no backend takes dk != dv
        log("kernels", kernel="flash_attention_mla",
            library=f"refused: {str(e)[:100]!r}")
    ms = cuda_ms_turns(fns, rounds=6)
    plain = cuda_ms(lambda: attention_plain(q, k, v, causal=True), 3, 1)
    plain_bwd = cuda_ms(lambda: plain_grads(q, k, v, g, causal=True), 3, 1)
    pairs = s * (s + 1) // 2
    shape = f"B={b} S={s} H={h} Hkv={hkv} D={dk}/{dv} causal bf16"
    flops = 2 * b * h * pairs * (dk + dv)
    nbytes = 2 * b * s * (h * dk + hkv * dk + hkv * dv + h * dv)
    t_fwd, by_fwd = bound(nbytes, flops, PEAK_FLOPS[torch.bfloat16])
    bflops = 2 * b * h * pairs * (3 * dk + 2 * dv)
    bbytes = 2 * b * s * (2 * h * (dk + dv) + 2 * hkv * (dk + dv))
    t_bwd, by_bwd = bound(bbytes, bflops, PEAK_FLOPS[torch.bfloat16])
    out = {"fwd": {"path": "moonlight-16b-a3b train", "shape": shape,
                   "max_abs_err": max(fwd_errs), "ms": ms["kernel"],
                   "kernel_ms": ms["kernel"], "plain_ms": plain,
                   "library_ms": ms.get("library"), "bound_ms": t_fwd,
                   "bound_by": by_fwd, "bytes": nbytes, "flops": flops},
           "bwd": {"path": "moonlight-16b-a3b train", "shape": shape,
                   "max_rel_err": max(bwd_errs), "ms": ms["bwd"],
                   "plain_ms": plain_bwd,
                   "library_ms": ms.get("library_bwd"), "bound_ms": t_bwd,
                   "bound_by": by_bwd, "bytes": bbytes, "flops": bflops}}
    for what, kern in out.items():
        log("kernels", kernel=f"flash_attention_mla {what}",
            **{k: kern[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by")})
    return out


def paged_kernel(gen: torch.Generator) -> dict:
    """The paged decode-attention kernel against its plain version at every
    dtype, head dim 32/64/128, 1/7/8/12/32 query heads per kv head and
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
                                         (32, 64, 128), (1, 7, 8, 12, 32),
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
    # plain version (a kernel of scalar loads, as an older tree's), never
    # a wrong answer; the launches after it run clean
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
def engine_parity(gen: torch.Generator, arch: str, max_new: int,
                  phase: str) -> dict:
    """``arch`` at full width, 2 layers, fp32 (TF32 off): the engine's
    greedy tokens (flash prefill, paged decode) for a 40-token prompt, a
    fork of it 5 tokens longer (mid-page: copy-on-write) and a 23-token
    prompt equal teacher-forced greedy tokens from the port's kernel-free
    ``dense.forward``.  Returns the path's launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch).replace(n_layers=2, compute_dtype="float32",
                                   attn_impl="pallas")
    model = get_model(cfg)
    params = model.init(gen, device="cuda")
    eng = Engine(model, params, EngineConfig(page_tokens=16, num_pages=256))
    rng = np.random.RandomState(1)
    n_base, n_fork, n_other = PARITY_PROMPTS
    base = rng.randint(0, cfg.vocab, n_base).astype(np.int32)  # 2.5 pages
    prompts = [base,
               np.concatenate([base, rng.randint(0, cfg.vocab,
                                                 n_fork - n_base)])
               .astype(np.int32),
               rng.randint(0, cfg.vocab, n_other).astype(np.int32)]
    fk.launches = pk.launches = 0
    a = eng.add(prompts[0], max_new=max_new)
    sids = [a, eng.add(prompts[1], max_new=max_new, fork_from=a),
            eng.add(prompts[2], max_new=max_new)]
    steps = 0
    while any(not eng._requests[s].done for s in sids):
        eng.step()
        steps += 1
    launches = {"flash_attention": fk.launches,
                "paged_attention": pk.launches}
    if (fk.launches, pk.launches) != (3 * 2, steps * 2):
        raise AssertionError(f"{arch} parity path launches {launches}, "
                             f"steps {steps}")
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
                raise AssertionError(f"{arch} seq {sid}: engine {out} vs "
                                     f"teacher-forced forward {want}")
    log(phase, arch=arch, layers=2, dtype="float32", requests=len(sids),
        new_tokens=max_new, steps=steps, tokens_equal=True,
        pages=eng.cache.stats,
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        launches=launches)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_parity(gen: torch.Generator) -> None:
    engine_parity(gen, "qwen2-7b", 8, "parity")


def phase_dense_parity(gen: torch.Generator) -> dict:
    """command-r-35b (parallel blocks) and mistral-large-123b through the
    engine as `engine_parity`, 16 new tokens; then llava-next-34b's forward
    over patch embeddings, flash against the einsum path."""
    launches = {f"{arch} dense_parity": engine_parity(gen, arch, 16,
                                                      "dense_parity")
                for arch in ("command-r-35b", "mistral-large-123b")}
    launches["llava-next-34b dense_parity"] = llava_parity(gen)
    return launches


def llava_parity(gen: torch.Generator) -> dict:
    """llava-next-34b at full width, 2 layers, fp32 (TF32 off): ``forward``
    with 576 patch embeddings of width 1024 and 64 text tokens, B=2,
    through the flash kernel equals the einsum path within 2e-3, the
    patches' logits stripped, and so do its greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("llava-next-34b").replace(
        n_layers=2, compute_dtype="float32", attn_impl="pallas")
    model = get_model(cfg)
    params = model.init(gen, device="cuda")
    b = 2
    batch = {"tokens": torch.from_numpy(np.random.RandomState(3).randint(
                 0, cfg.vocab, (b, LLAVA_TEXT))).cuda(),
             "patch_embeds": torch.randn(
                 (b, cfg.vlm.num_patches, cfg.vlm.vision_dim),
                 generator=gen, device="cuda")}
    fk.launches = 0
    with torch.no_grad():
        out = model.forward(params, batch)
        torch.cuda.synchronize()
        launches = {"flash_attention": fk.launches}
        ref = get_model(cfg.replace(attn_impl="xla")).forward(params, batch)
    if fk.launches != cfg.n_layers:
        raise AssertionError(f"llava forward launched flash {fk.launches}")
    if out.shape != ref.shape or out.shape[:2] != (b, LLAVA_TEXT):
        raise AssertionError(f"llava logits {tuple(out.shape)}")
    err = max_err(out, ref, torch.float32, "llava forward, flash vs einsum",
                  2e-3)
    if not torch.equal(out.argmax(-1), ref.argmax(-1)):
        raise AssertionError("llava greedy tokens differ")
    log("dense_parity", arch="llava-next-34b", layers=cfg.n_layers,
        dtype="float32", batch=b, patches=cfg.vlm.num_patches,
        vision_dim=cfg.vlm.vision_dim, text_tokens=LLAVA_TEXT,
        max_abs_err=f"{err:.3e}",
        max_abs_logit=f"{ref.abs().max().item():.3e}", tokens_equal=True,
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        launches=launches)
    del params, batch, out, ref
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 4
def profile_window(name: str, fn) -> None:
    """Run ``fn`` under torch.profiler; print the wall time, the device's
    busy time and idle share, and the kernels that took the most device
    time in the window, with the port's own kernels always among them,
    each with its share of the busy time; then the operators whose
    kernels took the most device time."""
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
    # the same device time by the PyTorch operator that launched it
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)
    for e in ops[:10]:
        t = e.self_device_time_total / 1e3
        print(f"[profile] {name}: {t:9.3f} ms {e.count:5d}x "
              f"{t / busy_ms:7.2%} op {e.key[:60]}")


def device_ops(fn) -> tuple:
    """(the operations (kernels, copies, fills) that ``fn`` puts on the
    card, their device ms summed), from a torch.profiler trace of its CUDA
    activity alone."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(ops), sum(e.time_range.elapsed_us() for e in ops) / 1e3


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
def run_prefills(prefill, params, batch, n: int, b: int, s: int, vocab: int,
                 check) -> list:
    """``n`` calls of ``prefill`` on fresh [b, s] token batches, each timed
    by the host clock to its synchronisation; ``check(i)`` checks the
    launch counts after call i, and the tokens must lie in the vocab."""
    ms = []
    for i in range(n):
        tokens = batch(b, s)
        t0 = time.perf_counter()
        nxt = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(i)
        if nxt.shape != (b,) or not bool(((nxt >= 0) & (nxt < vocab)).all()):
            raise AssertionError(f"prefill tokens {nxt.tolist()}")
    return ms


def run_decode(serve, params, cache, prompts: torch.Tensor, new: int,
               vocab: int) -> tuple:
    """Batched decode through ``serve``: the prompts [B, P] teacher-forced,
    then ``new`` greedy tokens, each step timed by the host clock to its
    synchronisation.  Returns (step ms, cache, the last step's batch)."""
    b, n_prompt = prompts.shape
    step_ms, out = [], []
    toks = prompts[:, :1]
    for t in range(n_prompt + new - 1):
        pos = torch.full((b,), t, dtype=torch.int32, device="cuda")
        t0 = time.perf_counter()
        nxt, cache = serve(params, cache, {"tokens": toks, "pos": pos})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if t >= n_prompt - 1:
            out.append(nxt)
        toks = (prompts[:, t + 1:t + 2] if t + 1 < n_prompt
                else nxt[:, None].long())
    gen_toks = torch.stack(out, dim=1)
    if gen_toks.shape != (b, new) or not bool(
            ((gen_toks >= 0) & (gen_toks < vocab)).all()):
        raise AssertionError(f"decode tokens {gen_toks.tolist()}")
    return step_ms, cache, {"tokens": toks, "pos": pos}


def serving_params(model, gen):
    """fp32 init, then the serving copy in bf16; (params, setup s, setup
    peak bytes)."""
    from repro_torch.models.common import tree_map
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      model.init(gen, device="cuda"))
    gc.collect()
    torch.cuda.synchronize()
    return (params, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


def phase_zamba2_serve(gen: torch.Generator, profile: bool = False) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.mamba2_scan import kernel as sk
    from repro_torch.models import get_model
    from repro_torch.train import make_prefill_step, make_serve_step

    ls = LONG_SERVE
    cfg = get_config("zamba2-1.2b").replace(attn_impl="pallas")
    model = get_model(cfg)
    params, setup_s, setup_peak = serving_params(model, gen)
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    rng = np.random.RandomState(0)
    n_sites = 6

    def batch(b, s):
        return torch.from_numpy(rng.randint(0, cfg.vocab, (b, s))).cuda()

    def check(i):
        if (sk.launches, fk.launches) != (cfg.n_layers * (i + 1),
                                          n_sites * (i + 1)):
            raise AssertionError(f"prefill {i}: ssd {sk.launches}, "
                                 f"flash {fk.launches} launches")

    torch.cuda.reset_peak_memory_stats()
    sk.launches = fk.launches = 0
    with torch.no_grad():
        prefill_ms = run_prefills(prefill, params, batch, ls.prefills,
                                  ls.prefill_b, ls.prefill_s, cfg.vocab,
                                  check)
    prefill_peak = torch.cuda.max_memory_allocated()
    launches = {"mamba2_scan": sk.launches, "flash_attention": fk.launches}

    torch.cuda.reset_peak_memory_stats()
    prompts = batch(ls.decode_b, ls.prompt)
    with torch.no_grad():
        step_ms, cache, last = run_decode(
            serve, params, model.init_cache(ls.decode_b, ls.cache_len),
            prompts, ls.new, cfg.vocab)
    decode_peak = torch.cuda.max_memory_allocated()
    if sk.launches != launches["mamba2_scan"]:
        raise AssertionError("decode launched the SSD-scan kernel")
    for name in ("ssm", "conv"):
        if not torch.isfinite(cache[name]).all():
            raise AssertionError(f"non-finite {name} cache")
    for name in ("k", "v"):
        if not torch.isfinite(cache["attn"][name]).all():
            raise AssertionError(f"non-finite attention {name} cache")
    if cache["attn"]["key_pos"].max().item() != ls.prompt + ls.new - 2:
        raise AssertionError("ring cache key positions")

    decode_s = sum(step_ms) / 1e3
    # tokens/s of the prefills after the first, which carries the warm-up
    prefill_tps = ls.prefill_b * ls.prefill_s * (ls.prefills - 1) \
        / (sum(prefill_ms[1:]) / 1e3)
    log("zamba2_serve", arch="zamba2-1.2b", layers=cfg.n_layers,
        attn_sites=n_sites, d_model=cfg.d_model, dtype=cfg.compute_dtype,
        params=model.param_count(),
        prefill_batch=ls.prefill_b, prefill_seq=ls.prefill_s,
        prefill_ms=[round(x, 3) for x in prefill_ms],
        prefill_tokens_per_s=f"{prefill_tps:.1f}",
        decode_batch=ls.decode_b, decode_steps=len(step_ms),
        cache_len=cache["attn"]["k"].shape[2],
        decode_ms_per_step=f"{np.mean(step_ms):.3f}",
        decode_ms_median=f"{np.median(step_ms):.3f}",
        decode_tokens_per_s=f"{ls.decode_b * len(step_ms) / decode_s:.1f}",
        setup_s=f"{setup_s:.3f}", setup_peak_gb=f"{setup_peak / 1e9:.3f}",
        prefill_peak_gb=f"{prefill_peak / 1e9:.3f}",
        decode_peak_gb=f"{decode_peak / 1e9:.3f}", launches=launches)
    if profile:
        # outside the counted run: one prefill, then 8 decode steps
        tokens = batch(ls.prefill_b, ls.prefill_s)
        with torch.no_grad():
            profile_window("zamba2 prefill x1",
                           lambda: prefill(params, {"tokens": tokens}))
            profile_window("zamba2 decode x8", lambda: [
                serve(params, cache, last) for _ in range(8)])
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------- phases 5b, 6b
class Routes:
    """While active, keeps what the port's `layers.moe_block` records of
    each call (`layers.ROUTE_LOG`): router probabilities, chosen experts
    (top_e [T, k]) and which choices kept a slot, on the card, no sync.
    Calls come in layer order, so call i of a model of L layers is layer
    i mod L."""

    def __enter__(self):
        from repro_torch.models import layers
        self.layers = layers
        self.calls = layers.ROUTE_LOG = []
        return self

    def __exit__(self, *exc):
        self.layers.ROUTE_LOG = None

    @property
    def top_e(self) -> list:
        return [c["top_e"] for c in self.calls]

    def min_margin(self) -> float:
        """The smallest gap between the k-th and (k+1)-th router
        probability met: a choice whose gap is at fp32 rounding may flip
        between two runs of the same function."""
        gaps = []
        for c in self.calls:
            k = c["top_e"].shape[1]
            top = torch.topk(c["probs"], k + 1, dim=-1).values
            gaps.append((top[:, k - 1] - top[:, k]).min())
        return torch.stack(gaps).min().item()

    def dropped(self, layer: int = 0, n_layers: int = 1) -> tuple:
        """(choices dropped by capacity, choices) over the calls of one
        layer, or over all calls with the defaults."""
        calls = self.calls[layer::n_layers]
        return (sum(int((~c["keep"]).sum()) for c in calls),
                sum(c["keep"].numel() for c in calls))

    def max_load(self, layer: int, n_layers: int, seqs: int, experts: int,
                 joined: bool = False) -> tuple:
        """The most-chosen expert's choices over an even share's, over
        each call's batch and within each of its ``seqs`` sequences (the
        mean over the layer's calls); ``joined`` takes the layer's calls
        as one, each sequence's choices over all of them (decode steps)."""
        calls = [c["top_e"].reshape(seqs, -1)
                 for c in self.calls[layer::n_layers]]
        if joined:
            calls = [torch.cat(calls, dim=1)]
        batch, per_seq = [], []
        for e in calls:
            one = torch.nn.functional.one_hot(e, experts).sum(1).float()
            even = e.shape[1] / experts
            batch.append((one.sum(0).max() / (even * seqs)).item())
            per_seq.append((one.max(1).values / even).mean().item())
        return float(np.mean(batch)), float(np.mean(per_seq))


def phase_moe_parity(gen: torch.Generator) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, s = 2, 256
    launches = {}
    for arch in ("olmoe-1b-7b", "granite-moe-3b-a800m"):
        cfg = get_config(arch)
        m = dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)
        cfg = cfg.replace(n_layers=2, compute_dtype="float32",
                          attn_impl="pallas", moe=m)
        model = get_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        params = model.init(gen, device="cuda")
        tokens = torch.from_numpy(np.random.RandomState(2).randint(
            0, cfg.vocab, (b, s))).cuda()
        fk.launches = 0
        with torch.no_grad():
            with Routes() as fwd:
                full = model.forward(params, {"tokens": tokens})
                torch.cuda.synchronize()
            if fk.launches != cfg.n_layers:
                raise AssertionError(f"{arch} forward launched flash "
                                     f"{fk.launches}")
            cache = model.init_cache(b, s)
            steps = []
            with Routes() as dec:
                for t in range(s):
                    logits, cache = model.decode_step(
                        params, cache, {"tokens": tokens[:, t:t + 1],
                                        "pos": torch.full(
                                            (b,), t, dtype=torch.int32,
                                            device="cuda")})
                    steps.append(logits[:, 0])
            stepped = torch.stack(steps, dim=1)
            torch.cuda.synchronize()
        if fk.launches != cfg.n_layers:
            raise AssertionError(f"{arch}: the stepped decode launched flash")
        # the decode's choices of step t, layer l are tokens (:, t) of the
        # forward's layer l; agreement = shared choices / all choices
        agree = 0
        for li in range(cfg.n_layers):
            dec_e = torch.stack(dec.top_e[li::cfg.n_layers], dim=1)
            one = [torch.nn.functional.one_hot(e.reshape(b * s, m.top_k),
                                               m.num_experts).sum(1)
                   for e in (fwd.top_e[li], dec_e)]
            agree += int((one[0] * one[1]).sum())
        agree_share = agree / (cfg.n_layers * b * s * m.top_k)
        margin = min(fwd.min_margin(), dec.min_margin())
        drops = fwd.dropped()[0] + dec.dropped()[0]
        log("moe_parity", arch=arch, routing_agree_share=f"{agree_share:.6f}",
            min_topk_margin=f"{margin:.3e}", dropped=drops)
        err = max_err(full, stepped, torch.float32,
                      f"{arch} forward vs stepped decode", 2e-3)
        same = (full.argmax(-1) == stepped.argmax(-1)).float().mean().item()
        if same != 1.0 or drops:
            raise AssertionError(f"{arch} greedy tokens differ: {same:.4f} "
                                 f"of positions agree, {drops} dropped")
        launches[f"{arch} moe_parity"] = {"flash_attention": fk.launches}
        log("moe_parity", arch=arch, layers=cfg.n_layers, dtype="float32",
            experts=f"{m.num_experts}/{m.e_pad} top-{m.top_k}",
            capacity_factor=m.capacity_factor, batch=b, seq=s,
            max_abs_err=f"{err:.3e}",
            max_abs_logit=f"{full.abs().max().item():.3e}",
            tokens_equal=True,
            peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
            launches=launches[f"{arch} moe_parity"])
        del params, cache, full, stepped, fwd, dec
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def phase_mla_parity(gen: torch.Generator) -> dict:
    """moonlight-16b-a3b as its benchmark cell trains it (stage 1 of 2: 14
    layers at full width, experts 0-7 of 64 held, the vocabulary's first
    20,480), weights from the benchmark's draw: the program's bf16 forward
    (the flash kernels at (192, 128)) against the plain fp32 reference on
    one microbatch of 2 × 4096 tokens.  The logits' gap, and per expert
    layer the share of choices that the two route differently
    (`layers.ROUTE_LOG` against the reference's own routing): the first
    layer's inputs differ by bf16's rounding alone, the later ones also by
    the flips before them.  The same forward in fp32 (the einsum path: the
    flash kernels are bf16) holds the model's code to the reference: no
    choice of the first expert layer routed differently, and the logits
    within MLA_FP32_GAP of their norm."""
    import torch.nn.functional as F
    from bench.families import mla_moe as fam
    from bench.harness import weights
    from bench.reference import mla_moe as ref
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import get_model
    from repro_torch.models import layers as L

    config = weights.load_config(MLA_CONFIG)
    m = fam.sizes(config)
    params = weights.draw(fam.shapes(m), 1, torch.float32,
                          torch.device("cuda"))
    model = get_model(fam.program_config(config, m, "training"))
    tok = torch.randint(0, m["vocab"], (2, MLA_FLASH_SHAPE["s"]),
                        generator=gen, device="cuda")
    exact = get_model(model.cfg.replace(compute_dtype="float32",
                                        attn_impl="xla"))
    ref.exact_fp32()
    L.ROUTE_LOG, ref.ROUTE_LOG = [], []
    try:
        with torch.no_grad():
            fk.launches = 0
            got = model.forward(params, {"tokens": tok}).float()
            launched = fk.launches
            routes = list(L.ROUTE_LOG)
            L.ROUTE_LOG.clear()
            got32 = exact.forward(params, {"tokens": tok})
            routes32 = list(L.ROUTE_LOG)
            want, _ = ref.forward(params, m, tok)
        theirs = list(ref.ROUTE_LOG)
    finally:
        L.ROUTE_LOG = ref.ROUTE_LOG = None
    if launched != m["n_layers"]:
        raise AssertionError(f"mla_parity: {launched} flash launches for "
                             f"{m['n_layers']} layers")
    first, last = m["held_first"], m["held_first"] + m["held"]

    def flip_shares(ours):
        """Per expert layer: the share of choices routed differently, and
        that of the choices to held experts."""
        flips, held = [], []
        for p, r in zip(ours, theirs):
            one = [F.one_hot(x["top_e"], m["n_experts"]).sum(1)
                   for x in (p, r)]
            flips.append(1 - float((one[0] * one[1]).sum())
                         / one[1].sum().item())
            hp, hr = (o[:, first:last] for o in one)
            held.append(float((hp - hr).abs().sum()) / 2
                        / max(float(hr.sum()), 1.0))
        return flips, held

    def rel_gap(x):
        return float((x.reshape(want.shape) - want).norm() / want.norm())

    flips, held_flips = flip_shares(routes)
    flips32, _ = flip_shares(routes32)
    log("mla_parity", layers=len(routes),
        logits_rel_gap=f"{rel_gap(got):.3e}",
        flip_share_first=f"{flips[0]:.6f}",
        flip_share_by_layer=",".join(f"{f:.4f}" for f in flips),
        held_flip_share_by_layer=",".join(f"{f:.4f}" for f in held_flips),
        fp32_logits_rel_gap=f"{rel_gap(got32):.3e}",
        fp32_flip_share_by_layer=",".join(f"{f:.5f}" for f in flips32))
    if flips32[0] or rel_gap(got32) > MLA_FP32_GAP:
        raise AssertionError(f"mla_parity: the fp32 forward is "
                             f"{rel_gap(got32):.3e} of the logits' norm "
                             f"from the reference, {flips32[0]:.2e} of the "
                             "first layer's choices routed differently")
    return {"moonlight-16b-a3b mla_parity": {"flash_attention": launched}}


def phase_moe_serve(gen: torch.Generator, profile: bool = False) -> dict:
    """olmoe-1b-7b as published through `make_prefill_step` and
    `make_serve_step`, with the zamba2 serve phase's traffic; the share of
    expert choices dropped by capacity, in all and per layer, and how
    unevenly each layer loads its experts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import get_model, layers
    from repro_torch.train import make_prefill_step, make_serve_step

    ls = LONG_SERVE
    cfg = get_config("olmoe-1b-7b").replace(attn_impl="pallas")
    model, m = get_model(cfg), cfg.moe
    params, setup_s, setup_peak = serving_params(model, gen)
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    rng = np.random.RandomState(0)

    def batch(b, s):
        return torch.from_numpy(rng.randint(0, cfg.vocab, (b, s))).cuda()

    def check(i):
        if fk.launches != cfg.n_layers * (i + 1):
            raise AssertionError(f"prefill {i}: flash {fk.launches} "
                                 "launches")

    torch.cuda.reset_peak_memory_stats()
    fk.launches = 0
    with torch.no_grad(), Routes() as pre_routes:
        prefill_ms = run_prefills(prefill, params, batch, ls.prefills,
                                  ls.prefill_b, ls.prefill_s, cfg.vocab,
                                  check)
    prefill_peak = torch.cuda.max_memory_allocated()
    launches = {"flash_attention": fk.launches}

    torch.cuda.reset_peak_memory_stats()
    prompts = batch(ls.decode_b, ls.prompt)
    with torch.no_grad(), Routes() as dec_routes:
        step_ms, cache, last = run_decode(
            serve, params, model.init_cache(ls.decode_b, ls.cache_len),
            prompts, ls.new, cfg.vocab)
    decode_peak = torch.cuda.max_memory_allocated()
    if fk.launches != launches["flash_attention"]:
        raise AssertionError("decode launched the flash kernel")
    for name in ("k", "v"):
        if not torch.isfinite(cache[name]).all():
            raise AssertionError(f"non-finite {name} cache")
    if cache["key_pos"].max().item() != ls.prompt + ls.new - 2:
        raise AssertionError("ring cache key positions")
    pre_drop, pre_all = pre_routes.dropped()
    dec_drop, dec_all = dec_routes.dropped()
    if pre_all != (ls.prefills * cfg.n_layers * ls.prefill_b * ls.prefill_s
                   * m.top_k):
        raise AssertionError(f"prefill routed {pre_all} choices")

    decode_s = sum(step_ms) / 1e3
    # tokens/s of the prefills after the first, which carries the warm-up
    prefill_tps = ls.prefill_b * ls.prefill_s * (ls.prefills - 1) \
        / (sum(prefill_ms[1:]) / 1e3)
    log("moe_serve", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, experts=f"{m.num_experts} top-{m.top_k}",
        d_expert=m.d_expert, dtype=cfg.compute_dtype,
        params=model.param_count(), active_params=model.active_param_count(),
        prefill_batch=ls.prefill_b, prefill_seq=ls.prefill_s,
        prefill_ms=[round(x, 3) for x in prefill_ms],
        prefill_tokens_per_s=f"{prefill_tps:.1f}",
        prefill_capacity=layers.moe_capacity(
            ls.prefill_b * ls.prefill_s, m),
        prefill_dropped_share=f"{pre_drop / pre_all:.6f}",
        decode_batch=ls.decode_b, decode_steps=len(step_ms),
        cache_len=cache["k"].shape[2],
        decode_ms_per_step=f"{np.mean(step_ms):.3f}",
        decode_ms_median=f"{np.median(step_ms):.3f}",
        decode_tokens_per_s=f"{ls.decode_b * len(step_ms) / decode_s:.1f}",
        decode_capacity=layers.moe_capacity(ls.decode_b, m),
        decode_dropped_share=f"{dec_drop / dec_all:.6f}",
        setup_s=f"{setup_s:.3f}", setup_peak_gb=f"{setup_peak / 1e9:.3f}",
        prefill_peak_gb=f"{prefill_peak / 1e9:.3f}",
        decode_peak_gb=f"{decode_peak / 1e9:.3f}", launches=launches)
    # per layer: the dropped share, and the most-chosen expert's load over
    # an even share's, over the batch and within each sequence (prefill:
    # a call's 4096-token sequences; decode: each sequence's 191 steps)
    n = cfg.n_layers
    for what, routes, seqs, joined in (
            ("prefill", pre_routes, ls.prefill_b, False),
            ("decode", dec_routes, ls.decode_b, True)):
        drop = [routes.dropped(li, n) for li in range(n)]
        load = [routes.max_load(li, n, seqs, m.num_experts, joined)
                for li in range(n)]
        log("moe_serve", routing=what,
            dropped_share_per_layer=[round(d / t, 6) for d, t in drop],
            max_load_batch_per_layer=[round(x, 4) for x, _ in load],
            max_load_seq_per_layer=[round(x, 4) for _, x in load],
            min_topk_margin=f"{routes.min_margin():.3e}")
    if profile:
        # outside the counted run: one prefill, then 8 decode steps
        tokens = batch(ls.prefill_b, ls.prefill_s)
        with torch.no_grad():
            profile_window("olmoe prefill x1",
                           lambda: prefill(params, {"tokens": tokens}))
            profile_window("olmoe decode x8", lambda: [
                serve(params, cache, last) for _ in range(8)])
    del params, cache, pre_routes, dec_routes
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- phases 5c, 6c
def whisper_config(**kw):
    """whisper-medium as published, or cut: ``layers`` sets both stacks'
    depth."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import EncDecConfig
    cfg = get_config("whisper-medium")
    layers = kw.pop("layers", None)
    if layers is not None:
        kw.update(n_layers=layers, encdec=EncDecConfig(
            encoder_layers=layers, encoder_seq=cfg.encdec.encoder_seq))
    return cfg.replace(**kw)


def whisper_frames(gen, b: int, cfg, dtype=torch.float32) -> torch.Tensor:
    """Random frame embeddings [b, 1500, d] (the conv frontend is a stub)."""
    return torch.randn((b, cfg.encdec.encoder_seq, cfg.d_model),
                       generator=gen, device="cuda").to(dtype)


def phase_whisper_parity(gen: torch.Generator) -> dict:
    """whisper-medium at full width, 2 encoder and 2 decoder layers, fp32
    (TF32 off), B=2, 1500 frames, 64 tokens: ``forward`` (flash, the
    encoder's non-causal) equals ``decode_step`` stepped token by token
    against the cross K/V of ``make_cross_kv`` (no kernel) within 2e-3,
    the kernel's ``encode`` equals the einsum path's, and the greedy
    tokens agree."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import get_model
    from repro_torch.models import whisper as W

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    cfg = whisper_config(layers=2, compute_dtype="float32",
                         attn_impl="pallas")
    model = get_model(cfg)
    params = model.init(gen, device="cuda")
    b, s = 2, WHISPER_TOKENS
    frames = whisper_frames(gen, b, cfg)
    tokens = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab, (b, s))).cuda()
    n = cfg.n_layers
    fk.launches = 0
    with torch.no_grad():
        full = model.forward(params, {"frames": frames, "tokens": tokens})
        torch.cuda.synchronize()
        if fk.launches != 2 * n:           # encoder and decoder self-attn
            raise AssertionError(f"whisper forward launched flash "
                                 f"{fk.launches}")
        launches = {"flash_attention": fk.launches}
        enc = W.encode(params, frames, cfg)
        enc_ref = W.encode(params, frames, cfg.replace(attn_impl="xla"))
        if fk.launches != 3 * n:
            raise AssertionError(f"encode launched flash {fk.launches}")
        enc_err = max_err(enc, enc_ref, torch.float32,
                          "whisper encode, flash vs einsum", 2e-3)
        cache = model.init_cache(b, s)
        cache["cross"] = W.make_cross_kv(params, enc, cfg)
        steps = []
        for t in range(s):
            logits, cache = model.decode_step(
                params, cache, {"tokens": tokens[:, t:t + 1],
                                "pos": torch.full((b,), t, dtype=torch.int32,
                                                  device="cuda")})
            steps.append(logits[:, 0])
        stepped = torch.stack(steps, dim=1)
        torch.cuda.synchronize()
    if fk.launches != 3 * n:
        raise AssertionError("the stepped decode launched a kernel")
    err = max_err(full, stepped, torch.float32,
                  "whisper forward vs stepped decode", 2e-3)
    same = (full.argmax(-1) == stepped.argmax(-1)).float().mean().item()
    if same != 1.0:
        raise AssertionError(f"whisper greedy tokens differ: {same:.4f} of "
                             "positions agree")
    log("whisper_parity", arch=cfg.name, encoder_layers=n, decoder_layers=n,
        dtype="float32", batch=b, frames=cfg.encdec.encoder_seq, tokens=s,
        max_abs_err=f"{err:.3e}",
        max_abs_logit=f"{full.abs().max().item():.3e}",
        encode_max_abs_err=f"{enc_err:.3e}", tokens_equal=True,
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        launches=launches)
    del params, cache, full, stepped, enc, enc_ref
    gc.collect()
    torch.cuda.empty_cache()
    return {"whisper-medium whisper_parity": launches}


def phase_whisper_serve(gen: torch.Generator, profile: bool = False) -> dict:
    """whisper-medium as published (24 + 24 layers), bf16: `encode` of 8 ×
    1500 frames (30 s of audio each) and `make_cross_kv`, twice; then a
    4-token decoder prompt teacher-forced and 60 greedy tokens through
    `make_serve_step` against `init_cache(8, 448)` (the decoder's
    context) with the cross K/V in it."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import get_model
    from repro_torch.models import whisper as W
    from repro_torch.train import make_serve_step

    ws = WHISPER_SERVE
    cfg = whisper_config(attn_impl="pallas")
    model = get_model(cfg)
    params, setup_s, setup_peak = serving_params(model, gen)
    serve = make_serve_step(model)
    frames = whisper_frames(gen, ws.batch, cfg, torch.bfloat16)

    torch.cuda.reset_peak_memory_stats()
    fk.launches = 0
    encode_ms = []
    with torch.no_grad():
        for i in range(ws.encodes):
            t0 = time.perf_counter()
            cross = W.make_cross_kv(params, W.encode(params, frames, cfg),
                                    cfg)
            torch.cuda.synchronize()
            encode_ms.append((time.perf_counter() - t0) * 1e3)
            want = cfg.encdec.encoder_layers * (i + 1)
            if fk.launches != want:
                raise AssertionError(f"encode {i}: flash {fk.launches} "
                                     f"launches, want {want}")
    encode_peak = torch.cuda.max_memory_allocated()
    launches = {"flash_attention": fk.launches}
    for name in ("k", "v"):
        if not torch.isfinite(cross[name]).all():
            raise AssertionError(f"non-finite cross {name}")

    torch.cuda.reset_peak_memory_stats()
    cache = model.init_cache(ws.batch, ws.context)
    cache["cross"] = cross
    del cross
    prompts = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (ws.batch, ws.prompt))).cuda()
    with torch.no_grad():
        step_ms, cache, last = run_decode(serve, params, cache, prompts,
                                          ws.new, cfg.vocab)
    decode_peak = torch.cuda.max_memory_allocated()
    if fk.launches != launches["flash_attention"]:
        raise AssertionError("decode launched the flash kernel")
    for name in ("k", "v"):
        if not torch.isfinite(cache["self"][name]).all():
            raise AssertionError(f"non-finite self-attention {name} cache")
    if cache["self"]["key_pos"].max().item() != ws.prompt + ws.new - 2:
        raise AssertionError("ring cache key positions")
    cross_gb = sum(t.numel() * t.element_size()
                   for t in cache["cross"].values()) / 1e9
    decode_s = sum(step_ms) / 1e3
    log("whisper_serve", arch=cfg.name,
        layers=f"{cfg.encdec.encoder_layers}+{cfg.n_layers}",
        d_model=cfg.d_model, vocab=cfg.vocab, dtype=cfg.compute_dtype,
        params=model.param_count(), batch=ws.batch,
        frames=cfg.encdec.encoder_seq,
        encode_ms=[round(x, 3) for x in encode_ms],
        audio_s_per_s=f"{ws.batch * 30 / (encode_ms[-1] / 1e3):.1f}",
        decode_steps=len(step_ms), context=ws.context,
        decode_ms_per_step=f"{np.mean(step_ms):.3f}",
        decode_ms_median=f"{np.median(step_ms):.3f}",
        decode_tokens_per_s=f"{ws.batch * len(step_ms) / decode_s:.1f}",
        cross_cache_gb=f"{cross_gb:.3f}",
        setup_s=f"{setup_s:.3f}", setup_peak_gb=f"{setup_peak / 1e9:.3f}",
        encode_peak_gb=f"{encode_peak / 1e9:.3f}",
        decode_peak_gb=f"{decode_peak / 1e9:.3f}", launches=launches)
    if profile:
        # outside the counted run: one encode, then 8 decode steps
        with torch.no_grad():
            profile_window("whisper encode x1", lambda: W.make_cross_kv(
                params, W.encode(params, frames, cfg), cfg))
            profile_window("whisper decode x8", lambda: [
                serve(params, cache, last) for _ in range(8)])
    del params, cache, frames
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_xlstm_parity(gen: torch.Generator) -> None:
    """xlstm-1.3b at full width (d 2048, 4 heads, dk 256 and dv 512 per
    head), one group (7 mLSTM layers and 1 sLSTM), fp32 (TF32 off), B=2,
    S=256: ``forward`` (chunked mLSTM) equals ``decode_step`` stepped token
    by token within 2e-3, with equal greedy tokens; and `mlstm_chunked`
    equals a loop of `mlstm_step` at the full head dims within the JAX
    package's 2e-4 / 2e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models import xlstm as X

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    base = get_config("xlstm-1.3b")
    cfg = base.replace(n_layers=base.xlstm.slstm_every,
                       compute_dtype="float32")
    model = get_model(cfg)
    params = model.init(gen, device="cuda")
    b, s = 2, 256
    tokens = torch.from_numpy(np.random.RandomState(9).randint(
        0, cfg.vocab, (b, s))).cuda()
    with torch.no_grad():
        full = model.forward(params, {"tokens": tokens})
        cache = model.init_cache(b, s)
        steps = []
        for t in range(s):
            logits, cache = model.decode_step(
                params, cache, {"tokens": tokens[:, t:t + 1],
                                "pos": torch.full((b,), t, dtype=torch.int32,
                                                  device="cuda")})
            steps.append(logits[:, 0])
        stepped = torch.stack(steps, dim=1)

        _, _, _, h, dkh, dvh = X._dims(cfg)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        q, k, v = rnd(b, s, h, dkh), rnd(b, s, h, dkh), rnd(b, s, h, dvh)
        ig, fg = rnd(b, s, h), rnd(b, s, h) + 2.0
        chunked, _ = X.mlstm_chunked(q, k, v, ig, fg, cfg.xlstm.chunk)
        st = (q.new_zeros((b, h, dvh, dkh)), q.new_zeros((b, h, dkh)),
              q.new_full((b, h), -float("inf")))
        outs = []
        for t in range(s):
            o, st = X.mlstm_step(st, q[:, t], k[:, t], v[:, t], ig[:, t],
                                 fg[:, t])
            outs.append(o)
        recurrent = torch.stack(outs, dim=1)
        torch.cuda.synchronize()
    err = max_err(full, stepped, torch.float32,
                  "xlstm forward vs stepped decode", 2e-3)
    same = (full.argmax(-1) == stepped.argmax(-1)).float().mean().item()
    if same != 1.0:
        raise AssertionError(f"xlstm greedy tokens differ: {same:.4f} of "
                             "positions agree")
    if not torch.isfinite(chunked).all() or not torch.allclose(
            chunked, recurrent, atol=2e-4, rtol=2e-3):
        raise AssertionError(
            "mlstm_chunked vs mlstm_step: max |err| "
            f"{(chunked - recurrent).abs().max().item():.3e}")
    log("xlstm_parity", arch=cfg.name, layers=cfg.n_layers,
        dtype="float32", batch=b, seq=s, chunk=cfg.xlstm.chunk,
        max_abs_err=f"{err:.3e}",
        max_abs_logit=f"{full.abs().max().item():.3e}", tokens_equal=True,
        chunked_vs_step_max_abs_err=
        f"{(chunked - recurrent).abs().max().item():.3e}",
        head_dims=f"dk {dkh} dv {dvh}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    del params, cache, full, stepped
    gc.collect()
    torch.cuda.empty_cache()


def phase_xlstm_serve(gen: torch.Generator, profile: bool = False) -> None:
    """xlstm-1.3b as published (48 layers), bf16: 2 prefills of 4 × 2048
    tokens (its training context) through `make_prefill_step`, the device
    ops of one more; then batch-8 decode through `make_serve_step`, 128
    teacher-forced and 64 greedy tokens.  No kernel on this path."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.train import make_prefill_step, make_serve_step

    xs = XLSTM_SERVE
    cfg = get_config("xlstm-1.3b")
    model = get_model(cfg)
    params, setup_s, setup_peak = serving_params(model, gen)
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    rng = np.random.RandomState(0)

    def batch(b, s):
        return torch.from_numpy(rng.randint(0, cfg.vocab, (b, s))).cuda()

    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        prefill_ms = run_prefills(prefill, params, batch, xs.prefills,
                                  xs.prefill_b, xs.prefill_s, cfg.vocab,
                                  lambda i: None)
        tokens = batch(xs.prefill_b, xs.prefill_s)
        ops, _ = device_ops(lambda: prefill(params, {"tokens": tokens}))
    prefill_peak = torch.cuda.max_memory_allocated()

    torch.cuda.reset_peak_memory_stats()
    prompts = batch(xs.decode_b, xs.prompt)
    with torch.no_grad():
        step_ms, cache, last = run_decode(
            serve, params, model.init_cache(xs.decode_b, xs.prefill_s),
            prompts, xs.new, cfg.vocab)
    decode_peak = torch.cuda.max_memory_allocated()
    for name, t in cache.items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite {name} state")
    state_gb = sum(t.numel() * t.element_size()
                   for t in cache.values()) / 1e9
    decode_s = sum(step_ms) / 1e3
    prefill_tps = xs.prefill_b * xs.prefill_s * (xs.prefills - 1) \
        / (sum(prefill_ms[1:]) / 1e3)
    log("xlstm_serve", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, vocab=cfg.vocab, dtype=cfg.compute_dtype,
        params=model.param_count(), prefill_batch=xs.prefill_b,
        prefill_seq=xs.prefill_s,
        prefill_ms=[round(x, 3) for x in prefill_ms],
        prefill_tokens_per_s=f"{prefill_tps:.1f}",
        device_ops_per_prefill=ops,
        decode_batch=xs.decode_b, decode_steps=len(step_ms),
        decode_ms_per_step=f"{np.mean(step_ms):.3f}",
        decode_ms_median=f"{np.median(step_ms):.3f}",
        decode_tokens_per_s=f"{xs.decode_b * len(step_ms) / decode_s:.1f}",
        state_gb=f"{state_gb:.3f}",
        setup_s=f"{setup_s:.3f}", setup_peak_gb=f"{setup_peak / 1e9:.3f}",
        prefill_peak_gb=f"{prefill_peak / 1e9:.3f}",
        decode_peak_gb=f"{decode_peak / 1e9:.3f}")
    if profile:
        # outside the counted run: one prefill, then 8 decode steps
        with torch.no_grad():
            profile_window("xlstm prefill x1",
                           lambda: prefill(params, {"tokens": tokens}))
            profile_window("xlstm decode x8", lambda: [
                serve(params, cache, last) for _ in range(8)])
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()


# the port's cost counter on the xlstm_train step, on meta tensors (a
# process of its own, no card)
XLSTM_TRAIN_COUNT = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import get_model
from repro_torch.roofline.cost import count
from repro_torch.train import abstract_state, make_train_step
s, b = map(int, sys.argv[1:3])
base = get_config("xlstm-1.3b")
model = get_model(base.replace(n_layers=base.xlstm.slstm_every))
_, ana = count(make_train_step(model), abstract_state(model),
               model.input_specs(ShapeConfig("xlstm_train", "train", s, b)))
print(json.dumps({"flops": ana.flops, "bytes": ana.bytes_accessed,
                  "temp_bytes": ana.peak_bytes}))
"""


def phase_xlstm_train(gen: torch.Generator, profile: bool = False) -> None:
    """xlstm-1.3b at full width, one group of 8 layers (7 mLSTM, 1 sLSTM),
    fp32 params, bf16 compute, remat "dots" as published, AdamW: one train
    step on batch 1 × 4096 tokens (train_4k's length) to warm up, two
    timed, and one more whose device activity a torch.profiler window
    records (its device busy ms and op count; the idle share is taken
    against the timed steps' median); the peak memory, and what the
    port's cost counter charges the same step on meta tensors (in a
    subprocess beside the profiled step).  No kernel on this path."""
    from repro_torch.checkpoint.serialize import flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.roofline import report
    from repro_torch.train import init_state, make_train_step

    xt = XLSTM_TRAIN
    base = get_config("xlstm-1.3b")
    cfg = base.replace(n_layers=base.xlstm.slstm_every)
    model = get_model(cfg)
    step = make_train_step(model)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(model, gen, device="cuda")
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab,
                                          (xt.b, xt.s + 1))).cuda()
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    step_ms, losses = [], []
    for _ in range(xt.warmup + xt.steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))        # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
    # the count runs beside the profiled step only: its host work would
    # slow the timed ones
    t_count = time.perf_counter()
    counter = subprocess.Popen(
        [sys.executable, "-c", XLSTM_TRAIN_COUNT, str(xt.s), str(xt.b)],
        env=dict(os.environ, PYTHONPATH=os.path.join(os.getcwd(), "src"),
                 CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ops, busy_ms = device_ops(lambda: step(state, batch))
        peak = torch.cuda.max_memory_allocated()
        out, err = counter.communicate(timeout=600)
    finally:
        if counter.poll() is None:
            counter.kill()
            counter.wait()
    if counter.returncode != 0:
        raise AssertionError(f"xlstm_train count failed:\n{err[-3000:]}")
    counted = json.loads(out.strip().splitlines()[-1])
    grad_norm = float(metrics["grad_norm"])
    if not np.isfinite(losses + [grad_norm]).all():
        raise AssertionError(f"xlstm train: loss {losses}, grad norm "
                             f"{grad_norm}")
    bad = [k for k, t in flatten_tree(state["params"]).items()
           if not torch.isfinite(t).all()]
    if bad:
        raise AssertionError(f"xlstm train: non-finite params {bad}")
    ms = float(np.median(step_ms[xt.warmup:]))
    log("xlstm_train", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, params=model.param_count(), batch=xt.b,
        seq=xt.s, remat=cfg.remat,
        dtype=f"params fp32, compute {cfg.compute_dtype}")
    log("xlstm_train", step_ms=f"{ms:.3f}",
        step_ms_all=[round(x, 3) for x in step_ms],
        device_busy_ms=f"{busy_ms:.3f}",
        device_idle_share=f"{1 - busy_ms / ms:.4f}",
        device_ops_per_step=ops, peak_gb=f"{peak / 1e9:.3f}",
        losses=[round(x, 5) for x in losses],
        grad_norm=f"{grad_norm:.6f}")
    log("xlstm_train", counted_bytes=f"{counted['bytes']:.4e}",
        counted_flops=f"{counted['flops']:.4e}",
        counted_memory_ms=f"{counted['bytes'] / report.HBM_BW * 1e3:.3f}",
        counted_temp_gb=f"{counted['temp_bytes'] / 1e9:.3f}",
        count_s=f"{time.perf_counter() - t_count:.3f}")
    if profile:
        profile_window("xlstm train step x1", lambda: step(state, batch))
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 7
def phase_train_parity(gen: torch.Generator) -> dict:
    """One train step's loss, grad norm and gradients with and without the
    kernels, from the same state, fp32 with TF32 off: smollm-360m at full
    width (2 layers) through the flash kernel against the einsum path;
    zamba2-1.2b at full width (7 layers) through the SSD-scan and flash
    kernels, and olmoe-1b-7b at full width (2 layers; loss = ce + aux),
    through the flash kernel, against the same step on the CPU (plain
    versions).  Returns each step's launches."""
    from repro_torch.checkpoint.serialize import flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.mamba2_scan import kernel as sk
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_map
    from repro_torch.train import make_grad_fn
    from repro_torch.train.optimizer import global_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, s = 2, 256

    def grads(cfg, params, tokens, **extra):
        loss, parts, g = make_grad_fn(get_model(cfg))(
            params, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
                     **extra})
        return (float(loss), float(parts["aux"]), float(global_norm(g)),
                {k: v.cpu() for k, v in flatten_tree(g).items()})

    def compare(arch, kern, plain, launches, against="plain"):
        (lk, ak, nk, gk), (lp, ap, np_, gp) = kern, plain
        tol = GRAD_TOL[arch]
        aux_err = abs(ak - ap) / abs(ap) if ap else abs(ak - ap)
        errs = {}
        for name, ref in gp.items():
            if not torch.isfinite(gk[name]).all():
                raise AssertionError(f"{arch}: non-finite gradient {name}")
            errs[name] = ((gk[name] - ref).abs().max()
                          / ref.abs().max().clamp_min(1e-30)).item()
        worst = max(errs, key=errs.get)
        loss_err, norm_err = abs(lk - lp) / abs(lp), abs(nk - np_) / np_
        if max(errs[worst], loss_err, norm_err, aux_err) > tol:
            raise AssertionError(
                f"{arch} train step: kernels vs plain, loss {lk} vs {lp}, "
                f"aux {ak} vs {ap}, "
                f"grad norm {nk} vs {np_}, worst gradient {worst} "
                f"{errs[worst]:.3e} of its largest entry (tol {tol})")
        log("train_parity", arch=arch, against=against, loss=f"{lk:.6f}",
            loss_plain=f"{lp:.6f}", aux=f"{ak:.6e}", aux_plain=f"{ap:.6e}",
            grad_norm=f"{nk:.6f}",
            grad_norm_plain=f"{np_:.6f}", loss_rel_err=f"{loss_err:.3e}",
            grad_norm_rel_err=f"{norm_err:.3e}", leaves=len(errs),
            worst_leaf=worst, worst_rel_err=f"{errs[worst]:.3e}", tol=tol,
            launches=launches)

    rng = np.random.RandomState(4)
    cfg = get_config("smollm-360m").replace(n_layers=2,
                                            compute_dtype="float32")
    params = get_model(cfg).init(gen, device="cuda")
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab, (b, s + 1))).cuda()
    fk.launches = 0
    kern = grads(cfg.replace(attn_impl="pallas"), params, tokens)
    if fk.launches != cfg.n_layers:
        raise AssertionError(f"smollm step launched flash {fk.launches}")
    plain = grads(cfg.replace(attn_impl="xla"), params, tokens)
    if fk.launches != cfg.n_layers:
        raise AssertionError("the einsum path launched the flash kernel")
    launches = {"smollm-360m train_parity": {"flash_attention":
                                             fk.launches}}
    compare("smollm-360m", kern, plain,
            launches["smollm-360m train_parity"])
    del params, kern, plain

    cfg = get_config("zamba2-1.2b").replace(n_layers=7,
                                            compute_dtype="float32",
                                            attn_impl="pallas")
    params = get_model(cfg).init(gen, device="cuda")
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab, (b, s + 1))).cuda()
    fk.launches = sk.launches = 0
    kern = grads(cfg, params, tokens)
    z_launches = {"mamba2_scan": sk.launches, "flash_attention": fk.launches}
    # remat "dots" (the published config's) runs each Mamba2 layer's
    # forward again in backward, scan included; the shared block is not
    # rematerialised
    if z_launches != {"mamba2_scan": 2 * cfg.n_layers, "flash_attention": 1}:
        raise AssertionError(f"zamba2 step launched {z_launches}")
    launches["zamba2-1.2b train_parity"] = z_launches
    t0 = time.perf_counter()
    plain = grads(cfg, tree_map(lambda t: t.cpu(), params), tokens.cpu())
    cpu_s = time.perf_counter() - t0
    log("train_parity", arch="zamba2-1.2b", cpu_step_s=f"{cpu_s:.3f}")
    compare("zamba2-1.2b", kern, plain, z_launches)
    del params, kern, plain

    # olmoe at its published remat "dots": every layer's attention runs
    # again in backward, flash included
    cfg = get_config("olmoe-1b-7b").replace(n_layers=2,
                                            compute_dtype="float32",
                                            attn_impl="pallas")
    params = get_model(cfg).init(gen, device="cuda")
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab, (b, s + 1))).cuda()
    fk.launches = 0
    with Routes() as routes:
        kern = grads(cfg, params, tokens)
    o_launches = {"flash_attention": fk.launches}
    if fk.launches != 2 * cfg.n_layers:
        raise AssertionError(f"olmoe step launched {o_launches}")
    launches["olmoe-1b-7b train_parity"] = o_launches
    t0 = time.perf_counter()
    plain = grads(cfg, tree_map(lambda t: t.cpu(), params), tokens.cpu())
    cpu_s = time.perf_counter() - t0
    drop, total = routes.dropped()
    log("train_parity", arch="olmoe-1b-7b", cpu_step_s=f"{cpu_s:.3f}",
        min_topk_margin=f"{routes.min_margin():.3e}",
        dropped_share=f"{drop / total:.6f}")
    compare("olmoe-1b-7b", kern, plain, o_launches)
    del params, kern, plain, routes

    # whisper, 2 + 2 layers over 1500 frames and 64 tokens: the encoder's
    # non-causal and the decoder's causal flash (remat "none": once each)
    # against the einsum path on the card, then the card against the CPU
    cfg = whisper_config(layers=2, compute_dtype="float32",
                         attn_impl="pallas")
    params = get_model(cfg).init(gen, device="cuda")
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab,
                                          (b, WHISPER_TOKENS + 1))).cuda()
    frames = whisper_frames(gen, b, cfg)
    fk.launches = 0
    kern = grads(cfg, params, tokens, frames=frames)
    w_launches = {"flash_attention": fk.launches}
    if fk.launches != 2 * cfg.n_layers:
        raise AssertionError(f"whisper step launched {w_launches}")
    launches["whisper-medium train_parity"] = w_launches
    plain = grads(cfg.replace(attn_impl="xla"), params, tokens,
                  frames=frames)
    compare("whisper-medium", kern, plain, w_launches, "einsum")
    t0 = time.perf_counter()
    plain = grads(cfg, tree_map(lambda t: t.cpu(), params), tokens.cpu(),
                  frames=frames.cpu())
    log("train_parity", arch="whisper-medium", against="cpu",
        cpu_step_s=f"{time.perf_counter() - t0:.3f}")
    compare("whisper-medium", kern, plain, w_launches, "cpu")
    del params, kern, plain

    # xlstm, one group (7 mLSTM, 1 sLSTM) at its published remat "dots":
    # no kernel; the card's chunked mLSTM and sLSTM loop against the CPU's.
    # The mLSTM output divides by max(|den|, exp(-m)), and about half the
    # positions sit on that floor at this init: a position within
    # rounding of it can take the other side on the CPU, and the gradient
    # jumps there (a batch did: one position of 14336 at a margin of
    # 2.5e-5, grad norm 181.8 vs 234.5).  So both sides record every
    # margin (`xlstm.DEN_LOG`): a side that differs must be a tie within
    # XLSTM_TIE, and the gradients are compared on a batch where no
    # position changes side, up to XLSTM_BATCHES batches
    from repro_torch.models import xlstm as X
    base = get_config("xlstm-1.3b")
    cfg = base.replace(n_layers=base.xlstm.slstm_every,
                       compute_dtype="float32")
    params = get_model(cfg).init(gen, device="cuda")
    cpu_params = tree_map(lambda t: t.cpu(), params)

    def logged_grads(p, toks):
        X.DEN_LOG = []
        try:
            out = grads(cfg, p, toks)
            return out, torch.cat([m.flatten().cpu() for m in X.DEN_LOG])
        finally:
            X.DEN_LOG = None

    for attempt in range(XLSTM_BATCHES):
        tokens = torch.from_numpy(rng.randint(0, cfg.vocab,
                                              (b, s + 1))).cuda()
        kern, m_card = logged_grads(params, tokens)
        t0 = time.perf_counter()
        plain, m_cpu = logged_grads(cpu_params, tokens.cpu())
        flips = (m_card > 0) != (m_cpu > 0)
        tie = max(m_card[flips].abs().max().item(),
                  m_cpu[flips].abs().max().item()) if flips.any() else 0.0
        log("train_parity", arch="xlstm-1.3b", remat=cfg.remat,
            batch_drawn=attempt + 1,
            cpu_step_s=f"{time.perf_counter() - t0:.3f}",
            positions=m_card.numel(),
            on_floor=int((m_card <= 0).sum()),
            min_margin=f"{m_card.abs().min().item():.3e}",
            sides_differ=int(flips.sum()), widest_differing=f"{tie:.3e}")
        if tie > XLSTM_TIE:
            raise AssertionError(f"xlstm: the card and the CPU put a "
                                 f"position on other sides of the floor "
                                 f"at a margin of {tie:.3e}")
        if not flips.any():
            compare("xlstm-1.3b", kern, plain, {}, "cpu")
            break
    else:
        raise AssertionError(f"xlstm: a position changed side in each of "
                             f"{XLSTM_BATCHES} batches")
    del params, cpu_params, kern, plain
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 8
def markov_stream(n: int, vocab: int, seed: int = 0) -> np.ndarray:
    """The learnable token stream of ``examples/train_lm.py``: next =
    (tok · 31 + 7 + noise) mod vocab, noise 1 with probability 1/3."""
    noise = (np.random.RandomState(seed).randint(3, size=n) == 0)
    toks = np.zeros(n, np.int64)
    for i in range(1, n):
        toks[i] = (toks[i - 1] * 31 + 7 + noise[i]) % vocab
    return toks.astype(np.int32)


def phase_train(profile: bool = False) -> dict:
    """smollm-360m as published, trained through the port's `Trainer` on a
    WTF cluster (4 servers, 2 replicas, 4 MiB regions) in a temporary
    directory: 20 steps with a checkpoint at 20, then a fresh trainer that
    restores step 20 (state bit for bit, cursor) and trains on to 24."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.serialize import flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.core import Cluster
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.data.records import write_token_shard
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import get_model
    from repro_torch.train import AdamWConfig, TrainHyper
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("smollm-360m").replace(attn_impl="pallas",
                                            max_seq=TRAIN_S)
    model = get_model(cfg)

    class TimedTrainer(Trainer):
        """Times the restore and the save (made synchronous), keeps the
        state as saved, and holds a restore against an expected state."""
        expect = saved = None
        save_s = restore_s = 0.0

        def restore_or_init(self):
            t0 = time.perf_counter()
            state, pstate = super().restore_or_init()
            torch.cuda.synchronize()
            self.restore_s = time.perf_counter() - t0
            if self.expect is not None:
                flat, cursor = flatten_tree(state), self.expect[1]
                for name, t in self.expect[0].items():
                    if not torch.equal(flat[name], t):
                        raise AssertionError(f"restored {name} differs")
                if pstate.to_dict() != cursor:
                    raise AssertionError(f"restored cursor {pstate} vs "
                                         f"{cursor}")
            self.state = state
            return state, pstate

        def _save(self, state, pstate, step):
            torch.cuda.synchronize()
            self.saved = ({k: t.clone() for k, t in
                           flatten_tree(state).items()}, pstate.to_dict())
            t0 = time.perf_counter()
            super()._save(state, pstate, step)
            self.async_ckpt.wait()
            self.save_s = time.perf_counter() - t0

    data_dir = tempfile.mkdtemp(prefix="wtf_train_")
    cluster = Cluster(n_servers=4, data_dir=data_dir, replication=2,
                      region_size=4 << 20)
    try:
        fs = cluster.client()
        fs.mkdir("/corpus")
        t0 = time.perf_counter()
        write_token_shard(fs, "/corpus/shard0", iter(markov_stream(
            TRAIN_B * (TRAIN_S + 1) * 32, cfg.vocab)), TRAIN_S + 1)
        corpus_s = time.perf_counter() - t0

        def trainer(total_steps):
            pipe = DataPipeline(fs, PipelineConfig(
                src_paths=("/corpus/shard0",), work_dir="/epochs",
                block_tokens=TRAIN_S + 1, global_batch=TRAIN_B, seed=0))
            return TimedTrainer(
                model, pipe, CheckpointManager(fs, "/ckpt", keep=3),
                hyper=TrainHyper(adamw=AdamWConfig(
                    lr=1e-3, warmup_steps=5,
                    decay_steps=TRAIN_RESTART_STEPS),
                    accum_steps=TRAIN_ACCUM),
                cfg=TrainerConfig(total_steps=total_steps,
                                  ckpt_every=TRAIN_STEPS, log_every=1),
                device="cuda")

        torch.cuda.reset_peak_memory_stats()
        fk.launches = fk.bwd_launches = 0
        first = trainer(TRAIN_STEPS)
        out1 = first.run()
        peak = torch.cuda.max_memory_allocated()
        second = trainer(TRAIN_RESTART_STEPS)
        second.expect = first.saved
        out2 = second.run()
        launches = {"flash_attention": fk.launches,
                    "flash_attention_bwd": fk.bwd_launches}
        manifest = second.ckpt.read_manifest()

        # every layer of every microbatch, forward and backward
        want = cfg.n_layers * TRAIN_ACCUM * TRAIN_RESTART_STEPS
        if launches != {"flash_attention": want, "flash_attention_bwd": want}:
            raise AssertionError(f"flash launches {launches}, want {want}")
        hist = out1["history"] + out2["history"]
        losses = {int(h["step"]): h["loss"] for h in hist}
        if sorted(losses) != list(range(1, TRAIN_RESTART_STEPS + 1)):
            raise AssertionError(f"steps logged {sorted(losses)}")
        if not all(np.isfinite(list(losses.values()))):
            raise AssertionError(f"non-finite losses {losses}")
        if not losses[TRAIN_STEPS] < losses[1]:
            raise AssertionError(f"loss did not fall: {losses}")
        if manifest["step"] != TRAIN_STEPS or manifest["pipeline"] != \
                {"epoch": 0, "step_in_epoch": TRAIN_STEPS}:
            raise AssertionError(f"checkpoint {manifest['step']} cursor "
                                 f"{manifest['pipeline']}")

        # wall time of each step (the trainer reads its metrics every step)
        step_ms = [1e3 / h["steps_per_s"] for h in out1["history"]]
        ms = float(np.median(step_ms[TRAIN_WARMUP:]))
        TRAIN_RESULT["ms_per_step"] = ms
        tokens = TRAIN_B * TRAIN_S
        n_params = model.param_count()
        # model FLOPs: 6·N per token for the matmuls, forward and backward,
        # and 6·L·H·D·S per token for causal attention (the plain recompute
        # in the attention backward is not counted)
        flops = tokens * (6 * n_params + 6 * cfg.n_layers * cfg.n_heads
                          * cfg.head_dim_ * TRAIN_S)
        peak_flops = PEAK_FLOPS[torch.bfloat16]
        ckpt_gb = sum(t.numel() * t.element_size()
                      for t in first.saved[0].values()) / 1e9
        log("train", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
            heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", d_ff=cfg.d_ff,
            vocab=cfg.vocab, params=n_params, seq=TRAIN_S,
            global_batch=TRAIN_B, accum_steps=TRAIN_ACCUM,
            dtype=f"params fp32, compute {cfg.compute_dtype}",
            attn_impl=cfg.attn_impl)
        log("train", ms_per_step=f"{ms:.3f}",
            ms_per_step_all=[round(x, 3) for x in step_ms],
            ms_per_step_after_restart=[round(1e3 / h["steps_per_s"], 3)
                                       for h in out2["history"]],
            tokens_per_s=f"{tokens / ms * 1e3:.1f}",
            model_tflops_per_step=f"{flops / 1e12:.3f}",
            model_tflops_per_s=f"{flops / ms / 1e9:.3f}",
            share_of_bf16_peak=f"{flops / ms * 1e3 / peak_flops:.4f}",
            peak_gb=f"{peak / 1e9:.3f}")
        log("train", loss_step_1=f"{losses[1]:.5f}",
            loss_step_20=f"{losses[TRAIN_STEPS]:.5f}",
            loss_step_24=f"{losses[TRAIN_RESTART_STEPS]:.5f}",
            losses=[round(losses[i], 5) for i in sorted(losses)])
        log("train", checkpoint_step=TRAIN_STEPS, state_gb=f"{ckpt_gb:.3f}",
            replicas=2, save_s=f"{first.save_s:.3f}",
            restore_s=f"{second.restore_s:.3f}",
            restored_bit_for_bit=True, cursor=manifest["pipeline"],
            corpus_s=f"{corpus_s:.3f}", launches=launches)
        if profile:
            # outside the counted run: two more steps after the restart's
            batch = second._batch(next(iter(second.pipeline)))
            profile_window("train step x2", lambda: [
                second.train_step(second.state, batch) for _ in range(2)])
        del first, second
    finally:
        cluster.close()
        shutil.rmtree(data_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phases 9, 10
def gloo_takes_cuda(group) -> str:
    """Whether gloo's all-gather takes CUDA tensors here (the sync sends
    its int8 through the host on gloo either way)."""
    import torch.distributed as dist
    x = torch.zeros(4, dtype=torch.int8, device="cuda")
    out = torch.empty(4 * dist.get_world_size(group), dtype=torch.int8,
                      device="cuda")
    try:
        dist.all_gather_into_tensor(out, x, group=group)
        return "yes"
    except (RuntimeError, ValueError) as e:
        return f"no ({type(e).__name__}: {str(e).splitlines()[0][:80]})"


def pod_sync_worker(rank: int, store: str, out_path: str) -> None:
    """One pod of the pod_sync phase (a process of its own): trains
    smollm-360m as published on its own WTF cluster, host ``rank`` of the
    pipeline, with `make_pod_sync` every POD_SYNC_EVERY steps; around each
    sync it snapshots the params, for observation only, and checks that
    both ranks hold the same bits and that every leaf lies within one
    quantization step of the fp32 mean of the ranks' pre-sync params."""
    import hashlib
    import shutil
    import tempfile
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.serialize import flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.core import Cluster
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.data.records import write_token_shard
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import get_model
    from repro_torch.train import AdamWConfig, TrainHyper
    from repro_torch.train.compression import make_pod_sync
    from repro_torch.train.trainer import Trainer, TrainerConfig

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=POD_RANKS)
    mesh = init_device_mesh("cuda", (POD_RANKS,), mesh_dim_names=("pod",))
    group = mesh.get_group("pod")
    takes_cuda = gloo_takes_cuda(group)
    sync = make_pod_sync(mesh)
    cfg = get_config("smollm-360m").replace(attn_impl="pallas",
                                            max_seq=TRAIN_S)
    model = get_model(cfg)
    syncs = []

    def observed_sync(params):
        pre = {k: v.detach().clone()
               for k, v in flatten_tree(params).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sync(params)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        # observation: the ranks' bits, and the fp32 mean of the pre-sync
        # params against one quantization step of the larger scale
        post = {k: v.detach().cpu() for k, v in flatten_tree(out).items()}
        digest = hashlib.sha256()
        for k in sorted(post):
            digest.update(post[k].numpy().tobytes())
        digests = [None] * POD_RANKS
        dist.all_gather_object(digests, digest.hexdigest(), group=group)
        scales = [None] * POD_RANKS
        dist.all_gather_object(scales, {k: float(v.abs().max()) / 127
                                        for k, v in pre.items()},
                               group=group)
        worst = 0.0
        for k, v in pre.items():
            mean = v.float().cpu()
            dist.all_reduce(mean, group=group)
            mean /= POD_RANKS
            step = max(sc[k] for sc in scales)
            err = float((post[k].float() - mean).abs().max())
            worst = max(worst, err / max(step, 1e-30))
        syncs.append({"ms": ms, "same_bits": len(set(digests)) == 1,
                      "worst_err_over_step": worst})
        del pre
        return out

    data_dir = tempfile.mkdtemp(prefix=f"wtf_pod{rank}_")
    cluster = Cluster(n_servers=4, data_dir=data_dir, replication=2,
                      region_size=4 << 20)
    try:
        fs = cluster.client()
        fs.mkdir("/corpus")
        write_token_shard(fs, "/corpus/shard0", iter(markov_stream(
            POD_RANKS * TRAIN_B * (TRAIN_S + 1) * 8, cfg.vocab)),
            TRAIN_S + 1)
        pipe = DataPipeline(fs, PipelineConfig(
            src_paths=("/corpus/shard0",), work_dir="/epochs",
            block_tokens=TRAIN_S + 1, global_batch=POD_RANKS * TRAIN_B,
            seed=0)).with_hosts(rank, POD_RANKS)
        trainer = Trainer(
            model, pipe, CheckpointManager(fs, "/ckpt", keep=1),
            hyper=TrainHyper(adamw=AdamWConfig(lr=1e-3, warmup_steps=5,
                                               decay_steps=POD_STEPS),
                             accum_steps=TRAIN_ACCUM),
            cfg=TrainerConfig(total_steps=POD_STEPS, ckpt_every=10 ** 9,
                              log_every=1, pod_sync_every=POD_SYNC_EVERY),
            pod_sync=observed_sync, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        fk.launches = fk.bwd_launches = 0
        out = trainer.run()
        launches = {"flash_attention": fk.launches,
                    "flash_attention_bwd": fk.bwd_launches}
        leaves = flatten_tree(model.abstract_params()).values()
        result = {
            "rank": rank, "launches": launches,
            "step_ms": [1e3 / h["steps_per_s"] for h in out["history"]],
            "losses": [h["loss"] for h in out["history"]],
            "syncs": syncs, "int8_bytes": sum(t.numel() for t in leaves),
            "scale_bytes": 4 * len(leaves),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "gloo_takes_cuda": takes_cuda}
        with open(out_path, "w") as f:
            json.dump(result, f)
        trainer.async_ckpt.wait()
    finally:
        cluster.close()
        shutil.rmtree(data_dir, ignore_errors=True)
        dist.destroy_process_group()


def phase_pod_sync() -> dict:
    """Two processes, one pod each, on the one card over gloo (NCCL takes
    one rank per device): each trains smollm-360m as published for
    POD_STEPS steps with the int8 pod sync every POD_SYNC_EVERY steps
    (`pod_sync_worker`).  Each sync must leave both ranks bit-identical and
    every leaf within one int8 step of the fp32 mean; each process must
    launch flash, forward and backward, on every layer of every
    microbatch."""
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="pod_sync_")
    outs = [os.path.join(work, f"rank{r}.json") for r in range(POD_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "_pod_sync_rank",
         str(r), os.path.join(work, "store"), outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(POD_RANKS)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"pod_sync rank exited {p.returncode}:\n"
                                 + text[-3000:])
    res = [json.load(open(o)) for o in outs]
    shutil.rmtree(work, ignore_errors=True)
    from repro_torch.configs import get_config
    want = get_config("smollm-360m").n_layers * TRAIN_ACCUM * POD_STEPS
    for r in res:
        if r["launches"] != {"flash_attention": want,
                             "flash_attention_bwd": want}:
            raise AssertionError(f"rank {r['rank']} flash launches "
                                 f"{r['launches']}, want {want}")
        if len(r["syncs"]) != POD_STEPS // POD_SYNC_EVERY:
            raise AssertionError(f"rank {r['rank']} synced "
                                 f"{len(r['syncs'])} times")
        for sy in r["syncs"]:
            if not sy["same_bits"]:
                raise AssertionError("ranks differ after a sync")
            if not sy["worst_err_over_step"] <= 1.0:
                raise AssertionError(f"a leaf is {sy['worst_err_over_step']}"
                                     " int8 steps from the fp32 mean")
    r0 = res[0]
    log("pod_sync", arch="smollm-360m", ranks=POD_RANKS, steps=POD_STEPS,
        sync_every=POD_SYNC_EVERY, backend="gloo",
        gloo_all_gather_takes_cuda=r0["gloo_takes_cuda"],
        transport="int8 and scales through the host (explicit)")
    for r in res:
        log("pod_sync", rank=r["rank"],
            sync_ms=[round(sy["ms"], 3) for sy in r["syncs"]],
            same_bits=[sy["same_bits"] for sy in r["syncs"]],
            worst_err_in_int8_steps=[round(sy["worst_err_over_step"], 4)
                                     for sy in r["syncs"]],
            flash_launches=r["launches"],
            peak_gb=f"{r['peak_gb']:.3f}",
            losses=[round(x, 5) for x in r["losses"]])
    log("pod_sync", int8_bytes_per_sync=r0["int8_bytes"],
        scale_bytes_per_sync=r0["scale_bytes"],
        step_ms_two_processes_sharing_one_card=[
            [round(x, 1) for x in r["step_ms"]] for r in res],
        note="not a speed figure: two processes share one card")
    return {name: sum(r["launches"][name] for r in res)
            for name in ("flash_attention", "flash_attention_bwd")}


DRYRUN_ONE_DEVICE = """
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import analyze_cell, fake_world
from repro_torch.train import TrainHyper
s, b, k = map(int, sys.argv[1:4])
with fake_world(1):
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    rec = analyze_cell("smollm-360m", ShapeConfig("train_card", "train", s,
                                                  b), mesh,
                       TrainHyper(accum_steps=k))
print(json.dumps(rec))
"""


def phase_dryrun() -> None:
    """The dry-run in subprocesses, all started together (no card; a fake
    process group): each cell of `DRYRUN_CELLS` on its production mesh
    through the module's command line, and one device at the train
    phase's own shape; the H100 roofline terms of each, each mesh cell
    against the JAX package's (`DRYRUN_REFERENCE`), and the train phase's
    measured step beside the one-device cell's bound where that phase
    ran."""
    from repro_torch.roofline import report
    with open(os.path.join(os.getcwd(), DRYRUN_REFERENCE)) as f:
        reference = {(r["arch"], r["shape"], r["mesh"]): r
                     for r in json.load(f)["cells"]}
    env = dict(os.environ, PYTHONPATH=os.path.join(os.getcwd(), "src"),
               CUDA_VISIBLE_DEVICES="")
    flag = {"pod": "single", "multipod": "multi"}
    procs = {(arch, shape, mesh): subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         arch, "--shape", shape, "--mesh", flag[mesh], "--force"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mesh, cells in DRYRUN_CELLS.items() for arch, shape in cells}
    procs["one"] = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_ONE_DEVICE, str(TRAIN_S),
         str(TRAIN_B), str(TRAIN_ACCUM)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    outs = {}
    try:
        for cell, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"dryrun {cell} failed:\n{err[-3000:]}")
            outs[cell] = out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cells = []
    for key in procs:
        if key == "one":
            continue
        arch, shape, mesh = key
        with open(os.path.join(os.getcwd(), "artifacts", "dryrun_torch",
                               f"{arch}__{shape}__{mesh}.json")) as f:
            cells.append((f"{mesh} {arch} {shape}", json.load(f)))
    card = json.loads(outs["one"].strip().splitlines()[-1])
    cells.append((f"one device, {TRAIN_B}x{TRAIN_S} accum {TRAIN_ACCUM}",
                  card))
    for name, rec in cells:
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun {name}: {rec}")
        t = report.terms(rec)
        log("dryrun", cell=name.replace(" ", "_"), chips=rec["chips"],
            torch=rec["torch_version"],
            flops_per_device=f"{rec['flops_per_device']:.4e}",
            bytes_per_device=f"{rec['bytes_per_device']:.4e}",
            compute_s=f"{t['compute_s']:.6f}",
            memory_s=f"{t['memory_s']:.6f}",
            collective_s=f"{t['collective_s']:.6f}", bound=t["bound"],
            step_s=f"{t['step_s']:.6f}", mfu=f"{t['mfu']:.4f}",
            temp_gb=f"{rec['memory']['temp_bytes'] / 1e9:.3f}",
            replicated=rec["replicated"], trace_s=rec["trace_s"])
        top = sorted(rec["collectives"], key=lambda o: -o["count"] * report
                     .wire_bytes(o["kind"], o["operand_bytes"],
                                 o["group_size"]) / report.link_bw(o))[:3]
        log("dryrun", cell=name.replace(" ", "_"), top_collectives=[
            (o["kind"], o["operand_bytes"], o["group_size"], o["span"],
             o["count"]) for o in top])
        if rec["chips"] == 1:
            continue
        ref = reference[(rec["arch"], rec["shape"], rec["mesh"])]
        ratio = rec["flops_per_device"] / ref["flops_per_device"]
        log("dryrun", cell=name.replace(" ", "_"),
            jax_flops_per_device=f"{ref['flops_per_device']:.4e}",
            flops_over_jax=f"{ratio:.4f}", bound=report.FLOP_BOUND,
            jax_collective_s=f"{ref['collective_s']:.6f}",
            collective_over_jax=f"{t['collective_s']
                                   / ref['collective_s']:.4f}",
            collective_bound=report.COLL_BOUND)
        flops_ok, coll_ok = report.within_reference(
            rec["flops_per_device"], t["collective_s"],
            ref["flops_per_device"], ref["collective_s"])
        if not flops_ok:
            raise AssertionError(f"dryrun {name}: {ratio:.3f} × JAX's FLOPs "
                                 f"per device (bound {report.FLOP_BOUND})")
        if not coll_ok:
            raise AssertionError(
                f"dryrun {name}: collective term {t['collective_s']:.4f} s "
                f"against JAX's {ref['collective_s']:.4f} s (bound "
                f"{report.COLL_BOUND}×)")
        if "aten.view.default" in rec["replicated"]:
            raise AssertionError(f"dryrun {name}: views placed by the "
                                 f"counter {rec['replicated']}")
    if "ms_per_step" in TRAIN_RESULT:
        ms = TRAIN_RESULT["ms_per_step"]
        step_s = report.terms(card)["step_s"]
        log("dryrun", train_measured_ms_per_step=f"{ms:.3f}",
            one_device_roofline_ms=f"{step_s * 1e3:.3f}",
            share_of_roofline=f"{step_s * 1e3 / ms:.4f}",
            note="the roofline counts the einsum attention path; the "
                 "train phase runs the flash kernel")


SHARDED_TRAIN_CASES = {     # cases 1 and 3 of the test of the same name
    "olmoe_b4_data2_model4": dict(
        arch="olmoe-1b-7b", kinds=["prefill", "decode", "train"], seq=16,
        batch=4, mesh=[2, 4], names=["data", "model"]),
    "olmoe_b16_accum2_pod2_data2_model2": dict(
        arch="olmoe-1b-7b", kinds=["train"], seq=16, batch=16, accum=2,
        mesh=[2, 2, 2], names=["pod", "data", "model"]),
}


def sharded_worker():
    """``tests/torch_sharded_worker.py`` of the checkout."""
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    import torch_sharded_worker
    return torch_sharded_worker


def start_sharded_train() -> dict:
    """Start each case of `SHARDED_TRAIN_CASES` in a thread of its own
    (each runs its ranks as processes that see no card); returns their
    futures, which `phase_sharded_train` reads."""
    from concurrent.futures import ThreadPoolExecutor
    worker = sharded_worker()
    pool = ThreadPoolExecutor(len(SHARDED_TRAIN_CASES))

    def timed_run(name, case):
        t0 = time.perf_counter()
        errs = worker.run(case, os.path.join(os.getcwd(), "build",
                                             "sharded_train", name),
                          timeout=600)
        return errs, time.perf_counter() - t0

    futures = {name: pool.submit(timed_run, name, case)
               for name, case in SHARDED_TRAIN_CASES.items()}
    pool.shutdown(wait=False)
    return futures


def phase_sharded_train(futures: dict, card: str) -> None:
    for name, future in futures.items():
        errs, seconds = future.result()
        log("sharded_train", case=name, seconds=f"{seconds:.3f}",
            card=repr(card), torch=torch.__version__,
            **{k: v if k.endswith("_differ") else f"{v:.3e}"
               for k, v in errs.items()})
        sharded_worker().check(errs, SHARDED_TRAIN_CASES[name]["kinds"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card; this script runs on the "
              "GPU only", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["_pod_sync_rank"]:
        pod_sync_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return 0
    # with no arguments every phase runs and the result lines are printed;
    # naming phases (kernels, parity, serve, dense_parity, zamba2_parity,
    # zamba2_serve, moe_parity, moe_serve, mla_parity, whisper_parity,
    # whisper_serve,
    # xlstm_parity, xlstm_serve, xlstm_train, train_parity, train,
    # pod_sync, dryrun, sharded_train, profile)
    # runs just those, to debug or to trace a serve or train phase; profile
    # alone traces the qwen2-7b serve phase
    phases = sys.argv[1:] or ["kernels", "parity", "serve", "dense_parity",
                              "zamba2_parity", "zamba2_serve", "moe_parity",
                              "moe_serve", "mla_parity", "whisper_parity",
                              "whisper_serve",
                              "xlstm_parity", "xlstm_serve", "xlstm_train",
                              "train_parity", "train", "pod_sync", "dryrun",
                              "sharded_train"]
    profile = "profile" in phases
    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log("time", of=name, seconds=f"{time.perf_counter() - t0:.3f}")
        return out

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    card = phase_card()
    # each path's launches, counted from 0 just before it is driven
    launches = {}
    if "kernels" in phases:
        kernels = timed("kernels", phase_kernels, gen(2))
    if "parity" in phases:
        timed("parity", phase_parity, gen(1))
    if "serve" in phases or (profile and not {
            "zamba2_serve", "moe_serve", "whisper_serve", "xlstm_serve",
            "xlstm_train", "train"} & set(phases)):
        launches["qwen2-7b serve"] = timed("serve", phase_serve, gen(0),
                                           profile)
    if "dense_parity" in phases:
        launches.update(timed("dense_parity", phase_dense_parity, gen(6)))
    if "zamba2_parity" in phases:
        timed("zamba2_parity", phase_zamba2_parity, gen(3))
    if "zamba2_serve" in phases:
        launches["zamba2-1.2b serve"] = timed(
            "zamba2_serve", phase_zamba2_serve, gen(0), profile)
    if "moe_parity" in phases:
        launches.update(timed("moe_parity", phase_moe_parity, gen(7)))
    if "moe_serve" in phases:
        launches["olmoe-1b-7b serve"] = timed("moe_serve", phase_moe_serve,
                                              gen(0), profile)
    if "mla_parity" in phases:
        launches.update(timed("mla_parity", phase_mla_parity, gen(11)))
    if "whisper_parity" in phases:
        launches.update(timed("whisper_parity", phase_whisper_parity,
                              gen(8)))
    if "whisper_serve" in phases:
        launches["whisper-medium serve"] = timed(
            "whisper_serve", phase_whisper_serve, gen(0), profile)
    if "xlstm_parity" in phases:
        timed("xlstm_parity", phase_xlstm_parity, gen(9))
    if "xlstm_serve" in phases:
        timed("xlstm_serve", phase_xlstm_serve, gen(0), profile)
    if "xlstm_train" in phases:
        timed("xlstm_train", phase_xlstm_train, gen(10), profile)
    if "train_parity" in phases:
        launches.update(timed("train_parity", phase_train_parity, gen(5)))
    if "train" in phases:
        launches["smollm-360m train"] = timed("train", phase_train, profile)
    if "pod_sync" in phases:
        launches["smollm-360m pod_sync"] = timed("pod_sync", phase_pod_sync)
    # on the CPU beside the dryrun phase's subprocesses
    sharded = start_sharded_train() if "sharded_train" in phases else None
    if "dryrun" in phases:
        timed("dryrun", phase_dryrun)
    if sharded:
        timed("sharded_train", phase_sharded_train, sharded, card)
    log("time", of="all", seconds=f"{time.perf_counter() - t_start:.3f}")
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
