"""Carry parameter and decode-cache trees across from the JAX package.

The JAX tree, as numpy (``jax.tree.map(np.asarray, params)``), has the
port's names, shapes and stacked-layer layout, so it maps one to one.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from .models.common import resolve_device


def _tensor(a: np.ndarray, device: torch.device,
            dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    keep = dtype
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart for from_numpy:
        # widen (exactly) to float32 and narrow again in torch
        a = a.astype(np.float32)
        keep = dtype or torch.bfloat16
    # restored arrays may be read-only views; from_numpy needs a writable one
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=keep or t.dtype)


def from_numpy(tree: Any, device: Union[str, torch.device],
               dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict of numpy arrays → the same nested dict of tensors on
    ``device`` (in ``dtype`` if given, else in each array's own dtype)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_numpy(v, dev, dtype) for k, v in tree.items()}
    return _tensor(tree, dev, dtype)
