"""npz snapshots of nested trees of tensors and arrays (port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.npz_store import (
    CheckpointManager,
    flatten_with_path,
    load_pytree,
    save_pytree,
)

__all__ = ["CheckpointManager", "flatten_with_path", "load_pytree", "save_pytree"]
