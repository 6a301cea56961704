"""What the benchmark loads and what it needs: no JAX and no JAX package in
a run, nothing of the program in the reference, the program beside it,
and a card."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "smollm-360m.train.2k"


def python(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    p = python(f"""
import sys
sys.path[:0] = ["src", "."]
from bench.harness import cell
from bench.tests import smoke
for name in smoke.CELLS:
    cell.run(name, smoke.SEED, 1.0, True, smoke.CPU,
             config=smoke.config(name), mix=smoke.mix(name),
             lim=smoke.limits(name))
print(cell.forbidden_modules(), "repro_torch" in sys.modules)
import repro.core
print(cell.forbidden_modules())
""")
    assert p.returncode == 0, p.stderr[-3000:]
    ran, after = p.stdout.strip().splitlines()[-2:]
    assert ran == "[] True"
    # the check tells the JAX package from the port by the whole name
    assert after == "['repro']"


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "bench", "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, f)).read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and not n.level]
        tops = {n.split(".")[0] for n in names}
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib",
                           "bench"}, (f, tops)


def test_run_fails_without_the_program_beside_it(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", CELL,
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env={k: v for k, v in os.environ.items()
                                         if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout == ""
    assert "no src/repro_torch" in p.stderr


def test_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here: the run would measure")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", CELL,
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA card" in p.stderr


def test_benchmark_names_its_files():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(
            ROOT, "bench", "traffic", f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(
            ROOT, "bench", "limits", f"{w['name']}.json"))
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "bench", "metrics",
                                           f"{m['name']}.py"))
