"""Transactional distributed checkpointing on WTF: atomic multi-host
commits, incremental (slice-shared) saves, zero-copy resharding."""
from .manager import AsyncCheckpointer, CheckpointManager
from .serialize import flatten_tree, unflatten_tree

__all__ = ["CheckpointManager", "AsyncCheckpointer", "flatten_tree",
           "unflatten_tree"]
