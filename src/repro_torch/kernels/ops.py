"""The paper's per-device algorithm on the three core kernels; port of
``repro.kernels.ops``.

The k=1 OS-ELM step (Eq. 12 with a scalar reciprocal) composes them as

    1. hidden_proj   h  = G(x·α + b)
    2. matmul_atb    ph = P·h (P symmetric, so hᵀP = (Ph)ᵀ: AᵀB with A = h)
    3. k1_update     denom = 1 + h·ph, err = t − h·β,
                     P' = P − ph·phᵀ/denom,  β' = β + ph·errᵀ/denom

three launches on the card (four with λ < 1, which divides P first); the
reference's ``jax.jit`` fuses the glue between its two rank-1 kernels, and
``k1_update`` takes that glue and both updates into one launch of the
rank-1 kernel's source. This is the reference kernel path's order: β is
updated with the old P's ph/denom (= P'h), where the reference's XLA step
multiplies by P'h itself.

``oselm_step_k1_kernel`` and ``uv_from_batch_kernel`` call the kernel
wrappers, which take their plain versions for CPU tensors and launch the
kernels for CUDA tensors; ``oselm_step_k1_plain`` and
``uv_from_batch_plain`` call the plain versions on any device, in the same
order, which is what the card's results are held against.
"""
from __future__ import annotations

import torch

from repro_torch.core.oselm import OSELMState
from repro_torch.kernels.hidden_proj import hidden_proj, hidden_proj_plain
from repro_torch.kernels.matmul_atb import matmul_atb, matmul_atb_plain
from repro_torch.kernels.rank1_add import k1_update, k1_update_plain

__all__ = [
    "oselm_step_k1_kernel",
    "oselm_step_k1_plain",
    "uv_from_batch_kernel",
    "uv_from_batch_plain",
    "uv_from_state_kernel",
]


def _step_k1(state: OSELMState, x, t, proj, atb, update) -> OSELMState:
    h = proj(x[None, :], state.params.alpha, state.params.bias,
             activation=state.activation)[0]                # (Ñ,)
    # P/1 is P itself, bit for bit: skip the copy on the paper's λ = 1
    p = state.p if state.forget == 1.0 else state.p / state.forget
    ph = atb(h[:, None], p)[0]                              # (Ñ,)
    p_new, beta_new = update(p, state.beta, h, ph, t)
    return state.replace(beta=beta_new, p=p_new)


def oselm_step_k1_kernel(state: OSELMState, x: torch.Tensor, t: torch.Tensor) -> OSELMState:
    """One k=1 step of one device, ``x`` (n,) and ``t`` (m,), through the
    kernels: one ``hidden_proj``, one ``matmul_atb`` and one ``k1_update``
    launch on the card (counted as ``rank1_add``)."""
    return _step_k1(state, x, t, hidden_proj, matmul_atb, k1_update)


def oselm_step_k1_plain(state: OSELMState, x: torch.Tensor, t: torch.Tensor) -> OSELMState:
    return _step_k1(state, x, t, hidden_proj_plain, matmul_atb_plain, k1_update_plain)


def _uv_from_batch(alpha, bias, x, t, activation, proj, atb):
    h = proj(x, alpha, bias, activation=activation)
    return atb(h, h), atb(h, t)


def uv_from_batch_kernel(
    alpha: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
    *, activation: str = "sigmoid",
) -> tuple[torch.Tensor, torch.Tensor]:
    """E²LM statistics straight from raw data, H = G(xα + b), U = HᵀH,
    V = Hᵀt: one ``hidden_proj`` and two ``matmul_atb`` launches on the
    card. Leading axes of ``x`` (..., k, n) and ``t`` (..., k, m) batch."""
    return _uv_from_batch(alpha, bias, x, t, activation, hidden_proj, matmul_atb)


def uv_from_batch_plain(
    alpha: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
    *, activation: str = "sigmoid",
) -> tuple[torch.Tensor, torch.Tensor]:
    return _uv_from_batch(alpha, bias, x, t, activation, hidden_proj_plain, matmul_atb_plain)


def uv_from_state_kernel(state: OSELMState, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The autoencoder variant (t = x)."""
    return uv_from_batch_kernel(state.params.alpha, state.params.bias, x, x,
                                activation=state.activation)
