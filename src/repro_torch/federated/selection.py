"""Fleet-level client-selection hooks (paper §4.2 last paragraph); port
of the array hooks of ``repro.federated.selection``. A policy maps the
(D,) per-device losses to a (D,) bool participation mask that the
merge governor ANDs into its quarantine mask."""
from __future__ import annotations

from typing import Callable

import numpy as np

FleetMaskFn = Callable[[np.ndarray], np.ndarray]


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
