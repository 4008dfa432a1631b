"""Batch ELM — the Extreme Learning Machine of §3.1, Eqs. 1–5 (port of
``repro.core.elm``).

SLFN y = G(x·α + b)·β with a random frozen (α, b); only β is trained, in
one shot: β̂ = (HᵀH + εI)⁻¹Hᵀt (``train_elm``). HᵀH and Hᵀt come from the
core kernels (``uv_from_batch_kernel``: one ``hidden_proj`` and two
``matmul_atb`` launches on the card). ``invert_u`` and ``solve_beta`` are
the Cholesky solves of Eqs. 4–5 and 13; the reference runs them through
XLA outside any Pallas kernel, so here they are ``torch.linalg`` calls.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.activations import get_activation


class SLFNParams(NamedTuple):
    """Frozen random projection shared by every device of a fleet."""

    alpha: torch.Tensor  # (n, Ñ)
    bias: torch.Tensor   # (Ñ,)

    @property
    def n_in(self) -> int:
        return self.alpha.shape[0]

    @property
    def n_hidden(self) -> int:
        return self.alpha.shape[1]


def init_slfn(
    generator: torch.Generator,
    n_in: int,
    n_hidden: int,
    *,
    dist: str = "uniform",
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
) -> SLFNParams:
    """Random frozen projection; ``dist`` matches the paper's p(x)=Uniform.
    The draw comes from ``generator`` (a CPU generator, so one seed gives
    one basis whatever the device) and is then moved to ``device`` (the
    card unless ``device="cpu"``)."""
    device = resolve_device(device)
    if dist == "uniform":
        alpha = torch.rand((n_in, n_hidden), generator=generator, dtype=dtype) * 2 - 1
        bias = torch.rand((n_hidden,), generator=generator, dtype=dtype) * 2 - 1
    elif dist == "normal":
        alpha = torch.randn((n_in, n_hidden), generator=generator, dtype=dtype)
        bias = torch.randn((n_hidden,), generator=generator, dtype=dtype)
    else:
        raise ValueError(f"unknown init dist {dist!r}")
    return SLFNParams(alpha=alpha.to(device), bias=bias.to(device))


def hidden(params: SLFNParams, x: torch.Tensor, activation: str = "sigmoid") -> torch.Tensor:
    """H = G(x·α + b) for x of shape (..., n)."""
    return get_activation(activation)(x @ params.alpha + params.bias)


def _ridged(u: torch.Tensor, ridge: float) -> torch.Tensor:
    n = u.shape[-1]
    return u + ridge * torch.eye(n, dtype=u.dtype, device=u.device)


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN for a matrix that is not positive
    definite, as ``jnp.linalg.cholesky`` returns it (``torch.linalg.cholesky``
    would raise, and on CUDA read the status back to the host)."""
    factor, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], factor, torch.nan)


def solve_beta(u: torch.Tensor, v: torch.Tensor, *, ridge: float = 0.0) -> torch.Tensor:
    """β = (U + εI)⁻¹V via Cholesky; batched over leading axes. The result
    is made contiguous (on CUDA the solver returns column-major)."""
    return torch.cholesky_solve(v, _cholesky(_ridged(u, ridge))).contiguous()


def invert_u(u: torch.Tensor, *, ridge: float = 0.0) -> torch.Tensor:
    """P = (U + εI)⁻¹ via Cholesky; batched over leading axes."""
    n = u.shape[-1]
    eye = torch.eye(n, dtype=u.dtype, device=u.device).expand_as(u)
    return torch.cholesky_solve(eye, _cholesky(_ridged(u, ridge))).contiguous()


class ELMModel(NamedTuple):
    params: SLFNParams
    beta: torch.Tensor  # (Ñ, m)
    activation: str = "sigmoid"


def _on(params: SLFNParams, x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=params.alpha.device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.asarray(x, np.float32), device=params.alpha.device)


def train_elm(
    params: SLFNParams,
    x,
    t,
    *,
    activation: str = "sigmoid",
    ridge: float = 0.0,
) -> ELMModel:
    """One-shot batch solve β̂ = (HᵀH + εI)⁻¹Hᵀt (Eqs. 4–5) for ``x`` (k, n)
    and ``t`` (k, m), arrays or tensors, on the basis's device."""
    from repro_torch.kernels.ops import uv_from_batch_kernel  # it imports this module

    u, v = uv_from_batch_kernel(params.alpha, params.bias, _on(params, x), _on(params, t),
                                activation=activation)
    return ELMModel(params=params, beta=solve_beta(u, v, ridge=ridge), activation=activation)


def predict_elm(model: ELMModel, x: torch.Tensor) -> torch.Tensor:
    return hidden(model.params, x, model.activation) @ model.beta
