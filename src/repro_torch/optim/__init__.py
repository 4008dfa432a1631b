"""Optimizers (port of the part of ``repro.optim`` the BP-NN baselines use)."""
from repro_torch.optim.optimizers import Optimizer, OptState, adam, tree_map

__all__ = ["Optimizer", "OptState", "adam", "tree_map"]
