"""OS-ELM — Online Sequential ELM (paper §3.3, Eqs. 9–13); port of
``repro.core.oselm``.

Sequential RLS update of β with P = K⁻¹; the paper's k=1 fast path
turns the k×k inverse into a scalar reciprocal. A forgetting factor λ
pre-scales P by 1/λ (λ=1, the paper's default, disables it).

The paper's per-device path runs on the core kernels (the reference's
``kernel=True`` routes), on the card and, through their plain versions,
on the CPU: the Eq. 13 statistics H₀ᵀH₀ and H₀ᵀt₀ through
``uv_from_batch_kernel``, the k=1 step through ``oselm_step_k1_kernel``
and a stream of k=1 steps through the fused fleet ingest with one device.

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
    # static metadata, no leaves of a snapshot (as in the reference)
    activation: str = dataclasses.field(default="sigmoid", metadata=dict(static=True))
    forget: float = dataclasses.field(default=1.0, metadata=dict(static=True))

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
    """Eq. 13: P₀ = (H₀ᵀH₀ + εI)⁻¹, β₀ = P₀H₀ᵀt₀, with U₀ = H₀ᵀH₀ and
    V₀ = H₀ᵀt₀ from ``uv_from_batch_kernel``. Leading axes of
    ``x0``/``t0`` batch over devices."""
    from repro_torch.kernels.ops import uv_from_batch_kernel  # it imports this module

    u0, v0 = uv_from_batch_kernel(params.alpha, params.bias, x0.contiguous(), t0.contiguous(),
                                  activation=activation)
    p0 = invert_u(u0, ridge=ridge)
    beta0 = solve_beta(u0, v0, ridge=ridge)
    return OSELMState(params=params, beta=beta0, p=p0, activation=activation, forget=forget)


def oselm_step(state: OSELMState, x: torch.Tensor, t: torch.Tensor) -> OSELMState:
    """Eq. 12 for a batch of k samples, ``x`` (k, n) and ``t`` (k, m),
    through a k×k inverse."""
    h = hidden(state.params, x, state.activation)       # (k, Ñ)
    p = state.p / state.forget
    ph = p @ h.T                                        # (Ñ, k)
    s = torch.eye(h.shape[0], dtype=p.dtype, device=p.device) + h @ ph
    gain = ph @ torch.linalg.inv(s)                     # (Ñ, k), the Kalman gain
    p_new = p - gain @ ph.T
    beta_new = state.beta + p_new @ h.T @ (t - h @ state.beta)
    return state.replace(beta=beta_new, p=p_new)


def oselm_step_k1(state: OSELMState, x: torch.Tensor, t: torch.Tensor) -> OSELMState:
    """One k=1 step of one device (the paper's deployed configuration):
    ``x`` is (n,), ``t`` is (m,). It runs ``oselm_step_k1_kernel``, whose
    wrappers launch the kernels on the card and run their plain versions,
    in the same order, on the CPU."""
    from repro_torch.kernels.ops import oselm_step_k1_kernel  # it imports this module

    return oselm_step_k1_kernel(state, x, t)


def oselm_train_sequential(state: OSELMState, xs: torch.Tensor, ts: torch.Tensor) -> OSELMState:
    """Stream the samples ``xs`` (T, n) with targets ``ts`` (T, m) one at
    a time (k=1) through the fused fleet ingest with one device (the
    reference's ``kernel=True`` route): on the card the kernel keeps
    (P, β) on chip across the stream, on the CPU its plain version runs
    the same chain."""
    from repro_torch.kernels.fleet_ingest import fleet_ingest  # it imports this module

    one = state.replace(beta=state.beta[None], p=state.p[None])
    out, _ = fleet_ingest(one, xs.contiguous()[None], ts.contiguous()[None])
    return out.replace(beta=out.beta[0], p=out.p[0])


def oselm_predict(state: OSELMState, x: torch.Tensor) -> torch.Tensor:
    return hidden(state.params, x, state.activation) @ state.beta


def oselm_loss(state: OSELMState, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-sample MSE, the paper's L."""
    return torch.mean((t - oselm_predict(state, x)) ** 2, dim=-1)
