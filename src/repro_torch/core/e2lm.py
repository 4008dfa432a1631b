"""E²LM intermediate form (paper §3.2, §4); port of ``repro.core.e2lm``.

U = P⁻¹, V = Uβ (Eq. 15) are the payload devices exchange; merged
payloads add (Eq. 8) and P ← (U+εI)⁻¹, β ← (U+εI)⁻¹V re-enters
sequential training. Leading axes batch over devices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.elm import invert_u, solve_beta
from repro_torch.core.oselm import OSELMState


class UV(NamedTuple):
    u: torch.Tensor  # (..., Ñ, Ñ)
    v: torch.Tensor  # (..., Ñ, m)


def to_uv(state: OSELMState, *, ridge: float = 0.0) -> UV:
    """Eq. 15: U = (P + εI)⁻¹, re-symmetrised, V = Uβ."""
    u = invert_u(state.p, ridge=ridge)
    u = 0.5 * (u + u.transpose(-1, -2))
    return UV(u=u, v=u @ state.beta)


def from_uv(state: OSELMState, uv: UV, *, ridge: float = 0.0) -> OSELMState:
    """§4.2 step 5: P ← (U+εI)⁻¹, β ← (U+εI)⁻¹V."""
    return state.replace(
        beta=solve_beta(uv.u, uv.v, ridge=ridge), p=invert_u(uv.u, ridge=ridge)
    )
