"""The port's int8 compression (`repro_torch.train.compression`) held
against the JAX package's: quantization bit for bit, the error bounds of
`tests/test_compression.py`, and the pod sync in two gloo processes
against JAX's on a (2, 2, 2) host mesh.  Rendezvous goes through a file
under the test's own directory, so parallel workers never share a port."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.compression import quantize_int8 as jax_quantize
from repro_torch.train.compression import (dequantize_int8, make_pod_sync,
                                           quantize_int8)

SRC = str(Path(__file__).resolve().parents[1] / "src")


@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e4, 0.0])
def test_quantize_equals_reference_bit_for_bit(scale):
    rng = np.random.RandomState(0)
    x = (rng.randn(128, 64) * scale).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jax_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()


@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e4])
def test_quantize_roundtrip_error_bound(scale):
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(128, 64) * scale).astype(np.float32))
    q, s = quantize_int8(x)
    y = dequantize_int8(q, s)
    # max error ≤ half a quantization step
    assert float((y - x).abs().max()) <= 0.5 * float(s) + 1e-12
    # RMS error well under 1% of the dynamic range
    rms = float(((y - x) ** 2).mean().sqrt())
    assert rms < 0.005 * float(x.abs().max())


def test_quantize_zero_tensor():
    q, s = quantize_int8(torch.zeros(16))
    assert float(dequantize_int8(q, s).abs().max()) == 0.0


def test_pod_sync_is_identity_without_a_pod_dim():
    sync = make_pod_sync(SimpleNamespace(mesh_dim_names=("data", "model")))
    tree = {"w": torch.ones(3)}
    assert sync(tree) is tree


def _inputs():
    rng = np.random.RandomState(0)
    base = {"w": rng.randn(64, 32).astype(np.float32),
            "b": (rng.randn(16) * 1e-3).astype(np.float32)}
    delta = {k: (rng.randn(*v.shape) * 0.1 * np.abs(v).max())
             .astype(np.float32) for k, v in base.items()}
    return base, delta


_JAX_SYNC = """
    import sys, numpy as np, jax
    from jax.sharding import NamedSharding, PartitionSpec
    from repro.launch.mesh import _make_mesh
    from repro.train.compression import make_pod_sync
    inp = np.load(sys.argv[1])
    mesh = _make_mesh((2, 2, 2), ("pod", "data", "model"))
    sync = make_pod_sync(mesh, compress=True)
    tree = {}
    for k in ("w", "b"):
        base, delta = inp["base_" + k], inp["delta_" + k]
        per_dev = [base + int(np.argwhere(mesh.devices == d)[0][0]) * delta
                   for d in mesh.devices.flat]
        tree[k] = jax.make_array_from_single_device_arrays(
            base.shape, NamedSharding(mesh, PartitionSpec()),
            [jax.device_put(v, d) for v, d in zip(per_dev,
                                                 mesh.devices.flat)])
    out = sync(tree)
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""
_TORCH_SYNC = """
    import sys, numpy as np, torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.train.compression import (compressed_psum_mean,
                                               make_pod_sync)
    inp, store, out_path, rank = sys.argv[1], sys.argv[2], sys.argv[3], \\
        int(sys.argv[4])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=2)
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("pod",))
    inp = np.load(inp)
    tree = {k: torch.from_numpy(inp["base_" + k] + rank * inp["delta_" + k])
            for k in ("w", "b")}
    res = {}
    for compress in (True, False):
        out = make_pod_sync(mesh, compress=compress)(tree)
        res.update({("int8_" if compress else "fp32_") + k: v.numpy()
                    for k, v in out.items()})
    direct = compressed_psum_mean(tree, mesh.get_group("pod"))
    res.update({"psum_" + k: v.numpy() for k, v in direct.items()})
    np.savez(out_path, **res)
    dist.destroy_process_group()
"""


def test_pod_sync_two_processes_equal_reference(tmp_path):
    """Two gloo ranks, one pod each, average a tree: int8 equals JAX's
    `make_pod_sync` on the same per-pod arrays within 1e-6 relative, both
    ranks hold the same bits, `compressed_psum_mean` on the pod group
    gives the sync's bits, and the fp32 mean is the exact mean."""
    base, delta = _inputs()
    inp = tmp_path / "inp.npz"
    np.savez(inp, **{f"base_{k}": v for k, v in base.items()},
             **{f"delta_{k}": v for k, v in delta.items()})
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_TORCH_SYNC), str(inp),
         str(tmp_path / "store"), str(tmp_path / f"torch{r}.npz"), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    jax_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_SYNC), str(inp),
         str(tmp_path / "jax.npz")], env=jax_env, capture_output=True,
        text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    want = np.load(tmp_path / "jax.npz")
    r0, r1 = np.load(tmp_path / "torch0.npz"), np.load(tmp_path / "torch1.npz")
    for k in ("w", "b"):
        assert r0[f"int8_{k}"].tobytes() == r1[f"int8_{k}"].tobytes()
        assert r0[f"psum_{k}"].tobytes() == r0[f"int8_{k}"].tobytes()
        np.testing.assert_allclose(r0[f"int8_{k}"], want[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(want[k]).max())
        exact = base[k] + 0.5 * delta[k]
        step = np.abs(base[k] + delta[k]).max() / 127
        assert np.abs(r0[f"int8_{k}"] - exact).max() <= step + 1e-6
        np.testing.assert_allclose(r0[f"fp32_{k}"], exact, rtol=1e-6,
                                   atol=1e-7 * np.abs(exact).max())
