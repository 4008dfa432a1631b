"""OS-ELM — Online Sequential ELM (paper §3.3, Eqs. 9–13); port of
``repro.core.oselm``.

Sequential RLS update of β with P = K⁻¹; the paper's k=1 fast path
turns the k×k inverse into a scalar reciprocal. A forgetting factor λ
pre-scales P by 1/λ (λ=1, the paper's default, disables it).

``OSELMState`` holds one device's state, or a whole fleet's when
``beta``/``p`` carry a leading device axis. A fleet keeps ONE shared
basis (α, b): Eq. 8 merging needs it, and storing it once saves the
D-fold copy the reference's stacked pytree carries.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.elm import SLFNParams, hidden, invert_u, solve_beta


@dataclasses.dataclass(frozen=True)
class OSELMState:
    params: SLFNParams
    beta: torch.Tensor   # (Ñ, m), or (D, Ñ, m) for a fleet
    p: torch.Tensor      # (Ñ, Ñ), or (D, Ñ, Ñ) for a fleet
    activation: str = "sigmoid"
    forget: float = 1.0

    @property
    def n_hidden(self) -> int:
        return self.beta.shape[-2]

    @property
    def n_out(self) -> int:
        return self.beta.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.beta.device

    def replace(self, **kw) -> "OSELMState":
        return dataclasses.replace(self, **kw)


def init_oselm(
    params: SLFNParams,
    x0: torch.Tensor,
    t0: torch.Tensor,
    *,
    activation: str = "sigmoid",
    ridge: float = 0.0,
    forget: float = 1.0,
) -> OSELMState:
    """Eq. 13: P₀ = (H₀ᵀH₀ + εI)⁻¹, β₀ = P₀H₀ᵀt₀. Leading axes of
    ``x0``/``t0`` batch over devices."""
    h0 = hidden(params, x0, activation)
    h0t = h0.transpose(-1, -2)
    u0 = h0t @ h0
    p0 = invert_u(u0, ridge=ridge)
    beta0 = solve_beta(u0, h0t @ t0, ridge=ridge)
    return OSELMState(params=params, beta=beta0, p=p0, activation=activation, forget=forget)


def oselm_step_k1(state: OSELMState, x: torch.Tensor, t: torch.Tensor) -> OSELMState:
    """One k=1 step of one device: ``x`` is (n,), ``t`` is (m,). The
    order of operations is the reference's (``oselm.py:111-118``)."""
    h = hidden(state.params, x[None, :], state.activation)[0]
    p = state.p / state.forget
    ph = p @ h
    denom = 1.0 + h @ ph
    p_new = p - torch.outer(ph, ph) / denom
    err = t - h @ state.beta
    beta_new = state.beta + torch.outer(p_new @ h, err)
    return state.replace(beta=beta_new, p=p_new)


def oselm_predict(state: OSELMState, x: torch.Tensor) -> torch.Tensor:
    return hidden(state.params, x, state.activation) @ state.beta


def oselm_loss(state: OSELMState, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-sample MSE, the paper's L."""
    return torch.mean((t - oselm_predict(state, x)) ** 2, dim=-1)
