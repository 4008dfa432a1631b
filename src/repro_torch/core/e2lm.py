"""E²LM intermediate form and the paper's cooperative model update
(§3.2, §4); port of ``repro.core.e2lm``.

U = P⁻¹, V = Uβ (Eq. 15) are the payload devices exchange; payloads
combine by addition (Eq. 8), and subtraction removes a dataset again.
P ← (U+εI)⁻¹, β ← (U+εI)⁻¹V re-enters sequential training. Leading axes
batch over devices.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core.elm import invert_u, solve_beta
from repro_torch.core.oselm import OSELMState


class UV(NamedTuple):
    """The exchanged intermediate results, the only payload devices share
    (never raw data: the paper's privacy argument)."""

    u: torch.Tensor  # (..., Ñ, Ñ) = Σ HᵀH
    v: torch.Tensor  # (..., Ñ, m) = Σ Hᵀt

    @property
    def nbytes(self) -> int:
        return self.u.numel() * self.u.element_size() + self.v.numel() * self.v.element_size()


def to_uv(state: OSELMState, *, ridge: float = 0.0) -> UV:
    """Eq. 15: U = (P + εI)⁻¹, re-symmetrised, V = Uβ."""
    u = invert_u(state.p, ridge=ridge)
    u = 0.5 * (u + u.transpose(-1, -2))
    return UV(u=u, v=u @ state.beta)


def uv_add(a: UV, b: UV) -> UV:
    """Eq. 8: the union of two datasets."""
    return UV(u=a.u + b.u, v=a.v + b.v)


def uv_sub(a: UV, b: UV) -> UV:
    """Removal of a dataset (E²LM supports it, §3.2)."""
    return UV(u=a.u - b.u, v=a.v - b.v)


def uv_replace(a: UV, old: UV, new: UV) -> UV:
    """Replacement of a dataset: subtraction, then addition."""
    return uv_add(uv_sub(a, old), new)


def uv_sum(parts: Sequence[UV]) -> UV:
    """N-way merge; equal to repeated ``uv_add`` up to f32 rounding."""
    return UV(u=torch.stack([p.u for p in parts]).sum(0),
              v=torch.stack([p.v for p in parts]).sum(0))


def from_uv(state: OSELMState, uv: UV, *, ridge: float = 0.0) -> OSELMState:
    """§4.2 step 5: P ← (U+εI)⁻¹, β ← (U+εI)⁻¹V."""
    return state.replace(
        beta=solve_beta(uv.u, uv.v, ridge=ridge), p=invert_u(uv.u, ridge=ridge)
    )


def cooperative_update(state: OSELMState, *remote: UV) -> OSELMState:
    """The one-shot cooperative model update (§4.2 steps 2–5): the local
    (U, V) plus every remote (U, V), in order, then back to (P, β)."""
    merged = to_uv(state)
    for r in remote:
        merged = uv_add(merged, r)
    return from_uv(state, merged)
