"""Fused fleet-tick ingest: the pre-train drift score plus the window's
k=1 RLS updates, in one pass; port of
``repro.kernels.fleet_ingest.fleet_ingest_kernel``.

``fleet_ingest`` dispatches by the device of the fleet: on the CPU it
runs ``fleet_ingest_plain``, on a CUDA device it launches the hand-written
kernel of ``csrc/fleet_ingest.cu`` (four launches on one stream, see the
source) or raises. The plain version follows the reference's order of
operations term by term: divide P by λ, ``ph``, ``denom``, the rank-1
update, then gain = P_new·h as a matvec; the β update is one fused
multiply-add, as the reference's compiler and the kernel both round it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.activations import ACTIVATION_CODES, get_activation
from repro_torch.core.oselm import OSELMState
from repro_torch.kernels import _lib
from repro_torch.kernels.topology_merge import _fma

__all__ = ["fleet_ingest", "fleet_ingest_cuda", "fleet_ingest_plain", "validate_shared_basis"]


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
    """Plain PyTorch version: (trained fleet, (D,) pre-train losses)."""
    _check_shapes(states, window, targets)
    tb = window if targets is None else targets
    g = get_activation(states.activation)
    h_all = g(window @ states.params.alpha + states.params.bias)        # (D, T, Ñ)
    e0 = tb - torch.bmm(h_all, states.beta)
    loss = torch.mean(e0 * e0, dim=(1, 2))
    p, be = states.p, states.beta
    for t in range(window.shape[1]):
        h = h_all[:, t]                                                # (D, Ñ)
        pf = p / states.forget
        ph = torch.bmm(pf, h[:, :, None])[:, :, 0]
        denom = 1.0 + torch.sum(h * ph, dim=1, keepdim=True)
        p = pf - ph[:, :, None] * ph[:, None, :] / denom[:, :, None]
        err = tb[:, t] - torch.bmm(h[:, None, :], be)[:, 0]
        gain = torch.bmm(p, h[:, :, None])[:, :, 0]
        be = _fma(gain[:, :, None], err[:, None, :], be)
    return states.replace(p=p, beta=be), loss


def fleet_ingest_cuda(
    states: OSELMState, window: torch.Tensor, targets: torch.Tensor | None = None
) -> tuple[OSELMState, torch.Tensor]:
    """Launch the CUDA ingest kernel; every operand must be a contiguous
    f32 tensor on one CUDA device."""
    _check_shapes(states, window, targets)
    tb = window if targets is None else targets
    alpha, bias = states.params.alpha, states.params.bias
    _lib.require_cuda_f32(
        "fleet_ingest", window=window, targets=tb, alpha=alpha, bias=bias,
        p=states.p, beta=states.beta,
    )
    d, t, n = window.shape
    nh, m = states.beta.shape[1], states.beta.shape[2]
    lib = _lib.library()
    for smem in (lib.repro_ingest_gain_smem(nh), lib.repro_ingest_beta_smem(nh)):
        if smem > _lib.MAX_SMEM:
            raise ValueError(f"fleet_ingest: Ñ={nh} needs {smem} B of shared memory per block")
    n_tiles = -(-m // lib.repro_ingest_beta_tile())
    dev = window.device
    p_out = torch.empty_like(states.p)
    beta_out = torch.empty_like(states.beta)
    loss = torch.empty(d, dtype=torch.float32, device=dev)
    h_ws = torch.empty((d, t, nh), dtype=torch.float32, device=dev)
    gain_ws = torch.empty((d, t, nh), dtype=torch.float32, device=dev)
    part_ws = torch.empty((d, n_tiles), dtype=torch.float32, device=dev)
    status = lib.repro_fleet_ingest(
        window.data_ptr(), tb.data_ptr(), alpha.data_ptr(), bias.data_ptr(),
        states.p.data_ptr(), states.beta.data_ptr(), p_out.data_ptr(), beta_out.data_ptr(),
        loss.data_ptr(), h_ws.data_ptr(), gain_ws.data_ptr(), part_ws.data_ptr(),
        d, t, n, nh, m, ACTIVATION_CODES[states.activation], float(states.forget),
        _lib.stream(),
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
