"""Fused fleet-tick ingest: the pre-train drift score plus the window's
k=1 RLS updates, in one pass; port of
``repro.kernels.fleet_ingest.fleet_ingest_kernel``.

``fleet_ingest`` dispatches by the device of the fleet: on the CPU it
runs ``fleet_ingest_plain``, on a CUDA device it launches the hand-written
kernel of ``csrc/fleet_ingest.cu`` (four launches on one stream, see the
source) or raises. The plain version follows the kernel's order of
operations. The P chain is the reference's, term by term: divide P by λ,
``ph``, ``denom``, the rank-1 update, then gain = P_new·h as a matvec. The
β update is taken as products, chunk by chunk (``ingest_chunks``, 64
samples, 32 past Ñ = 240, as the kernel chunks): the
pre-train errors E₀ = targets − H·β, L = strictly-lower(H·Gᵀ) of the
chunk's hidden rows and gains, the forward substitution E = (I + L)⁻¹E₀
(each error updated in sample order, one fused multiply-add a term), then
β += Σ_s gain_s·e_sᵀ in sample order, one fused multiply-add a sample, as
the sequential updates round it.

A registered activation with no code of the kernel's (a new name, or a
built-in name registered again) splits the C entry after its projection:
the projection runs with the identity code, the wrapper applies the
registered function to the hidden rows in place, and the P chain, β and
loss kernels take them from there (``repro_fleet_ingest_project`` then
``repro_fleet_ingest_update``). Either way a call counts one launch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.activations import ACTIVATION_CODES, get_activation, kernel_code
from repro_torch.core.elm import SLFNParams
from repro_torch.core.oselm import OSELMState
from repro_torch.kernels import _lib
from repro_torch.kernels.topology_merge import _fma

__all__ = [
    "INGEST_CHUNK",
    "INGEST_WIDE_CHUNK",
    "INGEST_WIDE_N",
    "fleet_ingest",
    "fleet_ingest_cuda",
    "fleet_ingest_paged",
    "fleet_ingest_plain",
    "ingest_chunk",
    "ingest_chunks",
    "validate_shared_basis",
]

# Samples of a chunk of the window, for the plain version: the kernel's
# (``repro_ingest_chunk``), which keeps a chunk's hidden rows, gains and L
# in shared memory beside a tile of β: 64 samples up to Ñ = 240, 32 past it.
INGEST_CHUNK = 64
INGEST_WIDE_CHUNK = 32
INGEST_WIDE_N = 240


def ingest_chunk(n_hidden: int) -> int:
    """The samples of a chunk at Ñ = ``n_hidden``."""
    return INGEST_CHUNK if n_hidden <= INGEST_WIDE_N else INGEST_WIDE_CHUNK


def ingest_chunks(t: int, chunk: int = INGEST_CHUNK) -> list[tuple[int, int]]:
    """The window's chunks as (start, stop): consecutive runs of at most
    ``chunk`` samples, in order, covering 0..t−1 once."""
    return [(c0, min(c0 + chunk, t)) for c0 in range(0, t, chunk)]


def validate_shared_basis(alpha) -> None:
    """Raise if a stacked (D, n, Ñ) basis is not one basis broadcast over
    the fleet (first and last device compared). The fused ingest projects
    every device through one (α, b); Eq. 8 merging needs the same."""
    a = np.asarray(alpha)
    if a.ndim == 3 and not np.array_equal(a[0], a[-1]):
        raise ValueError(
            "fused ingest requires the fleet-shared SLFN basis "
            "(init_fleet broadcasts one (α, b)); this stack carries "
            "per-device bases, which the kernel cannot honor"
        )


def _check_shapes(states: OSELMState, window: torch.Tensor, targets: torch.Tensor | None):
    if window.ndim != 3:
        raise ValueError(f"window must be (D, T, n); got {tuple(window.shape)}")
    d, t, n = window.shape
    nh, m = states.beta.shape[1], states.beta.shape[2]
    if states.beta.shape[0] != d or states.p.shape != (d, nh, nh):
        raise ValueError(
            f"fleet state (beta {tuple(states.beta.shape)}, p {tuple(states.p.shape)}) "
            f"does not match a window of {d} devices"
        )
    if states.params.alpha.shape != (n, nh):
        raise ValueError(
            f"shared basis alpha must be ({n}, {nh}); got {tuple(states.params.alpha.shape)}"
        )
    if targets is None:
        if m != n:
            raise ValueError(f"autoencoder ingest needs m == n; got m={m}, n={n}")
    elif targets.shape != (d, t, m):
        raise ValueError(f"targets must be {(d, t, m)}; got {tuple(targets.shape)}")


def fleet_ingest_plain(
    states: OSELMState, window: torch.Tensor, targets: torch.Tensor | None = None
) -> tuple[OSELMState, torch.Tensor]:
    """Plain PyTorch version: (trained fleet, (D,) pre-train losses), in
    f32 whatever the operands' floating types, as the reference computes."""
    _check_shapes(states, window, targets)
    window = window.float()
    tb = window if targets is None else targets.float()
    alpha, bias = (x.float() for x in states.params)
    states = states.replace(p=states.p.float(), beta=states.beta.float())
    g = get_activation(states.activation)
    h_all = g(window @ alpha + bias)                                    # (D, T, Ñ)
    e0 = tb - torch.bmm(h_all, states.beta)
    loss = torch.mean(e0 * e0, dim=(1, 2))
    p, gains = states.p, []
    for t in range(window.shape[1]):
        h = h_all[:, t]                                                # (D, Ñ)
        pf = p / states.forget
        ph = torch.bmm(pf, h[:, :, None])[:, :, 0]
        denom = 1.0 + torch.sum(h * ph, dim=1, keepdim=True)
        p = pf - ph[:, :, None] * ph[:, None, :] / denom[:, :, None]
        gains.append(torch.bmm(p, h[:, :, None])[:, :, 0])
    be = states.beta
    for c0, c1 in ingest_chunks(window.shape[1], ingest_chunk(states.p.shape[1])):
        h, gain = h_all[:, c0:c1], torch.stack(gains[c0:c1], dim=1)   # (D, Tc, Ñ)
        e = (e0 if c0 == 0 else tb[:, c0:c1] - torch.bmm(h, be))[:, : c1 - c0].clone()
        lmat = torch.bmm(h, gain.transpose(1, 2))                      # L[t, s] = h_t·gain_s
        for s in range(c1 - c0 - 1):  # every later error takes term s, in order of s
            e[:, s + 1 :] = _fma(-lmat[:, s + 1 :, s : s + 1], e[:, s : s + 1], e[:, s + 1 :])
        for s in range(c1 - c0):
            be = _fma(gain[:, s, :, None], e[:, s, None, :], be)
    return states.replace(p=p, beta=be), loss


def fleet_ingest_cuda(
    states: OSELMState, window: torch.Tensor, targets: torch.Tensor | None = None
) -> tuple[OSELMState, torch.Tensor]:
    """Launch the CUDA ingest kernel on the operands of one CUDA device,
    as ``_lib.operands`` hands them to it (f32, contiguous)."""
    _check_shapes(states, window, targets)
    window, tb, alpha, bias, p, beta = _lib.operands(
        "fleet_ingest", window=window, targets=window if targets is None else targets,
        alpha=states.params.alpha, bias=states.params.bias, p=states.p, beta=states.beta,
    )
    d, t, n = window.shape
    nh, m = beta.shape[1], beta.shape[2]
    lib = _lib.library()
    n_tiles = -(-m // lib.repro_ingest_beta_tile())
    dev = window.device
    p_out = torch.empty_like(p)
    beta_out = torch.empty_like(beta)
    loss = torch.empty(d, dtype=torch.float32, device=dev)
    h_ws = torch.empty((d, t, nh), dtype=torch.float32, device=dev)
    gain_ws = torch.empty((d, t, nh), dtype=torch.float32, device=dev)
    part_ws = torch.empty((d, n_tiles), dtype=torch.float32, device=dev)
    code = kernel_code(states.activation)
    if code is not None:
        status = lib.repro_fleet_ingest(
            window.data_ptr(), tb.data_ptr(), alpha.data_ptr(), bias.data_ptr(),
            p.data_ptr(), beta.data_ptr(), p_out.data_ptr(), beta_out.data_ptr(),
            loss.data_ptr(), h_ws.data_ptr(), gain_ws.data_ptr(), part_ws.data_ptr(),
            d, t, n, nh, m, code, float(states.forget), _lib.stream(),
        )
    else:
        status = lib.repro_fleet_ingest_project(
            window.data_ptr(), alpha.data_ptr(), bias.data_ptr(), h_ws.data_ptr(), d, t, n, nh,
            ACTIVATION_CODES["identity"], _lib.stream(),
        )
        _lib.check(status, "fleet_ingest")
        h_ws.copy_(get_activation(states.activation)(h_ws))
        status = lib.repro_fleet_ingest_update(
            tb.data_ptr(), p.data_ptr(), beta.data_ptr(), p_out.data_ptr(),
            beta_out.data_ptr(), loss.data_ptr(), h_ws.data_ptr(), gain_ws.data_ptr(),
            part_ws.data_ptr(), d, t, nh, m, float(states.forget), _lib.stream(),
        )
    _lib.check(status, "fleet_ingest")
    _lib.count_launch("fleet_ingest")
    return states.replace(p=p_out, beta=beta_out), loss


def fleet_ingest(
    states: OSELMState, window: torch.Tensor, targets: torch.Tensor | None = None
) -> tuple[OSELMState, torch.Tensor]:
    """Fused tick ingest: (trained fleet, (D,) mean pre-train loss of each
    device's window — the drift signal). ``targets`` None is the
    autoencoder tick (targets = window)."""
    if window.device.type == "cpu":
        return fleet_ingest_plain(states, window, targets)
    return fleet_ingest_cuda(states, window, targets)


def fleet_ingest_paged(
    p: torch.Tensor,
    beta: torch.Tensor,
    alpha: torch.Tensor,
    bias: torch.Tensor,
    window: torch.Tensor,
    *,
    activation: str = "sigmoid",
    forget: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused ingest over one arena page's raw leaves: P (C, Ñ, Ñ) and
    β (C, Ñ, m) against the shared basis α (n, Ñ), b (Ñ,), as the
    cohort-paged runtime holds them. It rebuilds the page as an
    ``OSELMState`` over the one (n, Ñ) basis (no per-device copy of it is
    made) and runs ``fleet_ingest``; returns (P′, β′, the (C,) pre-train
    losses)."""
    states = OSELMState(params=SLFNParams(alpha=alpha, bias=bias), beta=beta, p=p,
                        activation=activation, forget=forget)
    trained, losses = fleet_ingest(states, window)
    return trained.p, trained.beta, losses
