"""int8 parameter compression for the cross-pod axis (the port of the JAX
package's ``train/compression.py``).

`quantize_int8` maps each leaf to int8 with one fp32 scale per leaf
(max|x| / 127, floored at 1e-30); `compressed_psum_mean` averages a tree
over a process group with int8 on the wire: each rank quantizes its leaf
on its own device, the int8 values and the scales are all-gathered, and
every rank dequantizes each pod's part with that pod's scale, sums in
fp32 in pod order and divides by the number of pods, so all ranks hold the
same bits.  That is 4× less traffic than fp32 (2× less than bf16) at the
error bound of `tests/test_compression.py`.

The JAX version also computes an int32 ``psum`` of the quantized values
and discards it (its ``compression.py:41, 46``); the port's result is the
same without that collective.

Used by the trainer's ``pod_sync`` (local-steps mode: pods run K local
steps and periodically average parameters across pods).

Transport: the collectives run on whatever backend the group has.  The
gloo backend takes CPU tensors only, so on a gloo group the int8 values
and the scales cross through the host explicitly (one copy off the card
before the all-gather, one back after); NCCL takes them where they lie.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..models.common import tree_map

Q_MAX = 127.0


def quantize_int8(x: torch.Tensor):
    """(q int8, scale fp32 0-d): scale = max|x| / 127, at least 1e-30."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max() / Q_MAX, 1e-30)
    q = torch.clamp(torch.round(xf / scale), -Q_MAX, Q_MAX).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _wire_device(group) -> torch.device:
    """Where the group's collectives take their tensors: the host for
    gloo, the card otherwise."""
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _mean_int8(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    q, scale = quantize_int8(x)
    wire = _wire_device(group)
    q, scale = q.reshape(-1).to(wire), scale.reshape(1).to(wire)
    q_all = torch.empty((n * q.numel(),), dtype=q.dtype, device=wire)
    s_all = torch.empty((n,), dtype=scale.dtype, device=wire)
    dist.all_gather_into_tensor(q_all, q, group=group)
    dist.all_gather_into_tensor(s_all, scale, group=group)
    q_all = q_all.to(x.device).view((n,) + x.shape)
    s_all = s_all.to(x.device)
    total = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(n):                  # fp32 sum in pod order
        total += dequantize_int8(q_all[i], s_all[i])
    return (total / n).to(x.dtype)


def _mean_fp32(x: torch.Tensor, group) -> torch.Tensor:
    wire = _wire_device(group)
    y = x.float().to(wire, copy=True)
    dist.all_reduce(y, group=group)
    return (y / dist.get_world_size(group)).to(x.device, x.dtype)


def compressed_psum_mean(tree: Any, group) -> Any:
    """Mean of a tree of tensors across ``group``, int8 on the wire."""
    return tree_map(lambda x: _mean_int8(x, group), tree)


def make_pod_sync(mesh, compress: bool = True) -> Callable:
    """Parameter averaging across the "pod" dim of ``mesh`` (a
    `DeviceMesh`), tree → new tree; the identity when the mesh has no pod
    dim.  ``compress=False`` is an fp32 all-reduce mean."""
    if "pod" not in (mesh.mesh_dim_names or ()):
        return lambda tree: tree
    group = mesh.get_group("pod")
    mean = _mean_int8 if compress else _mean_fp32

    @torch.no_grad()
    def sync(tree):
        return tree_map(lambda x: mean(x, group), tree)

    return sync
