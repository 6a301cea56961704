"""Array/pytree (de)serialization for WTF checkpoints.

Layout: each leaf is one WTF file of raw little-endian bytes; a checkpoint's
``manifest`` records the tree structure, dtypes, shapes, and per-leaf
content digests.  Digests enable incremental checkpoints (unchanged leaves
are ``copy``'d — zero data I/O), and the manifest is the unit of atomicity.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Tuple

import numpy as np

from repro_torch.util import jsonio


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Flatten a nested dict/list/tuple pytree into {path: leaf}."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten_tree(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def unflatten_tree(flat: Dict[str, Any], template: Any) -> Any:
    """Rebuild ``template``'s structure from {path: leaf}."""

    def build(node: Any, prefix: str) -> Any:
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, tuple):
            items = [build(v, f"{prefix}{i}/") for i, v in enumerate(node)]
            if hasattr(node, "_fields"):          # NamedTuple (OptState)
                return type(node)(*items)
            return tuple(items)
        if isinstance(node, list):
            return [build(v, f"{prefix}{i}/") for i, v in enumerate(node)]
        return flat[prefix.rstrip("/")]

    return build(template, "")


def leaf_to_bytes(leaf: Any) -> Tuple[bytes, dict]:
    arr = np.asarray(leaf)
    data = np.ascontiguousarray(arr).tobytes()
    meta = {
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
        "digest": hashlib.blake2b(data, digest_size=16).hexdigest(),
        "nbytes": len(data),
    }
    return data, meta


def bytes_to_leaf(data: bytes, meta: dict) -> np.ndarray:
    arr = np.frombuffer(data, dtype=np.dtype(meta["dtype"]))
    return arr.reshape(meta["shape"])


def encode_manifest(entries: Dict[str, dict], extra: dict) -> bytes:
    return jsonio.dumps({"leaves": entries, **extra})


def decode_manifest(raw: bytes) -> dict:
    return jsonio.loads(raw)
