"""Optimizers (port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (
    Optimizer,
    OptState,
    adam,
    adamw,
    clip_by_global_norm,
    global_norm,
    sgd,
    tree_leaves,
    tree_map,
)

__all__ = ["Optimizer", "OptState", "adam", "adamw", "sgd", "clip_by_global_norm",
           "global_norm", "tree_leaves", "tree_map"]
