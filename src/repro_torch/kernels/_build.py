"""Build the port's CUDA sources and load them with ctypes.

Each ``src/repro_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on its own, at first use, by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch/<name>.so <name>.cu

into ``build/repro_torch/`` at the repository root (git-ignored).  A
library is rebuilt when its source, or any shared header ``csrc/*.cuh``
(Hopper's TMA, mbarrier and wgmma wrappers), is newer.  A tensor map for
TMA is encoded through the runtime's ``cudaGetDriverEntryPoint``, so the
libraries link only the CUDA runtime.  Nothing is built from outside
the repository, and the sources include no PyTorch header, so a build takes
seconds.  Every C entry point returns ``cudaGetLastError()``; `check`
raises on a nonzero code.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "port's kernels are built with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.so"


def sources(name: str) -> list:
    """What library ``name`` is built from: its ``.cu`` and the shared
    headers."""
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]


def _stale(name: str) -> bool:
    lib = library_path(name)
    return not lib.exists() or lib.stat().st_mtime < max(
        src.stat().st_mtime for src in sources(name))


def build(names: Iterable[str], extra_flags: Iterable[str] = ()
          ) -> Dict[str, str]:
    """Compile the stale sources among ``names``, one nvcc each, all
    started together.  Returns each compiler's output (``-Xptxas -v`` in
    ``extra_flags`` makes it report registers and shared memory)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"{name}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))   # atomic for other loaders
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first if it is stale."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
