"""Batch ELM pieces the OS-ELM path needs (port of ``repro.core.elm``).

SLFN y = G(x·α + b)·β with a random frozen (α, b). ``invert_u`` and
``solve_beta`` are the Cholesky solves of Eqs. 4–5 and 13; the
reference runs them through XLA outside any Pallas kernel, so here they
are ``torch.linalg`` calls.
"""
from __future__ import annotations

from typing import NamedTuple

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
