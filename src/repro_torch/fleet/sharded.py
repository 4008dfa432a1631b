"""Tier 2 of the two-tier cohort merge; port of the single-process part of
``repro.fleet.sharded`` (``_tree_fold``, ``cohort_tree_reduce``).

Eq. 8 is a sum, so the inter-cohort tier of the paged merge
(``repro_torch.fleet.arena.CohortMerger``) is a pure reduction of the
stacked per-cohort partial (U, V) sums. On one process it is a pairwise
binary tree over the leading axis, in the reference's order. The mesh
branch (each shard folds its resident cohorts, then one all-reduce) lands
with the multi-process merges (ROADMAP queue 1, item 8); until then a
``mesh`` raises ``NotImplementedError``.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

__all__ = ["cohort_tree_reduce"]


def require_no_mesh(mesh) -> None:
    """Raise where a caller asks for the mesh branch, which is not ported."""
    if mesh is not None:
        raise NotImplementedError(
            "cohort_tree_reduce over a mesh is not ported yet (ROADMAP queue 1, "
            "item 8: multi-process merges); pass mesh=None for the single-process tree")


def _tree_fold(stack: torch.Tensor) -> torch.Tensor:
    """Pairwise binary-tree sum over the leading axis: each round adds the
    even entries to the odd ones that follow them and carries an odd tail
    last, until one entry is left. The order the paged merge's agreement
    with the flat merge is stated against."""
    while stack.shape[0] > 1:
        n = stack.shape[0]
        even = stack[0 : n - (n % 2) : 2] + stack[1::2]
        if n % 2:
            even = torch.cat([even, stack[n - 1 :]], dim=0)
        stack = even
    return stack[0]


def cohort_tree_reduce(
    partials, mesh=None, axes: Sequence[str] = ("data",)
) -> torch.Tensor:
    """Reduce the stacked per-cohort partial sums ``(n_cohorts, R, C) →
    (R, C)`` by the pairwise tree, on the partials' device (a numpy array
    is taken on the CPU). ``mesh`` must be None."""
    require_no_mesh(mesh)
    if not isinstance(partials, torch.Tensor):
        partials = torch.from_numpy(np.asarray(partials))
    if partials.ndim < 1 or partials.shape[0] < 1:
        raise ValueError(f"need at least one partial; got shape {tuple(partials.shape)}")
    return _tree_fold(partials)
