"""Client-selection strategy hooks (paper §4.2 last paragraph); port of
``repro.federated.selection``.

The paper merges a predefined device set and cites two lines of work on
selection: resource-constrained selection (ref [19]) and excluding
unsatisfying local models (ref [20]). Two levels:

- **id-level** (``SelectFn``): callables over client ids, the per-round
  hooks of ``cooperative_round(select=...)`` (``federated.protocol``);
- **fleet-level** (``FleetMaskFn``): a policy maps the (D,) per-device
  losses to a (D,) bool participation mask that the merge governor ANDs
  into its quarantine mask.
"""
from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np

SelectFn = Callable[[Sequence[str]], Sequence[str]]
FleetMaskFn = Callable[[np.ndarray], np.ndarray]


def all_clients(ids: Sequence[str]) -> Sequence[str]:
    """The paper's default: the predefined device set merges whole."""
    return ids


def resource_constrained_selection(budgets: Mapping[str, float], threshold: float) -> SelectFn:
    """Ref [19]: only clients whose estimated round time fits the
    deadline take part (a client without an estimate does not)."""

    def select(ids: Sequence[str]) -> Sequence[str]:
        return [i for i in ids if budgets.get(i, float("inf")) <= threshold]

    return select


def loss_threshold_selection(local_losses: Mapping[str, float], max_loss: float) -> SelectFn:
    """Ref [20]: local models whose validation loss exceeds ``max_loss``
    (or that report none) stay out of the aggregation."""

    def select(ids: Sequence[str]) -> Sequence[str]:
        return [i for i in ids if local_losses.get(i, float("inf")) <= max_loss]

    return select


def fleet_loss_threshold(max_loss: float) -> FleetMaskFn:
    """Ref [20]: devices whose loss exceeds ``max_loss`` (or is not
    finite) sit the round out."""

    def select(losses: np.ndarray) -> np.ndarray:
        losses = np.asarray(losses)
        return np.isfinite(losses) & (losses <= max_loss)

    return select


def fleet_resource_budget(round_cost: np.ndarray, deadline: float) -> FleetMaskFn:
    """Ref [19]: a fixed per-device round-time estimate; devices that
    cannot meet ``deadline`` are excluded whatever their loss."""
    fits = np.asarray(round_cost) <= deadline

    def select(losses: np.ndarray) -> np.ndarray:
        return fits

    return select
