"""Fleet-scale OS-ELM federation on stacked tensors; port of
``repro.fleet.fleet``.

The whole fleet is ONE ``OSELMState`` whose ``beta``/``p`` carry a
leading device axis and whose SLFN basis (α, b) is shared. Training goes
through the fused ingest (``repro_torch.kernels.fleet_ingest``). Merges
come in two forms:

- ``fleet_merge`` / ``fleet_merge_masked`` — the plain forms, Cholesky
  solves once per equivalence class of merged models (one for a fully
  connected merge, one per isolated cluster, one per device otherwise);
- ``fleet_merge_masked_kernel`` — the runtime's form, on the merge
  kernels: the masked segment sum (star, hierarchical), the fused
  banded merge+solve (open ring) and the Gauss-Jordan solve.

A participation mask keeps masked-out devices out of every neighbour's
sum, and they keep their own (P, β) bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import UV, OSELMState, from_uv, init_oselm, init_slfn, to_uv
from repro_torch.core.elm import hidden, invert_u, solve_beta
from repro_torch.fleet.topology import Topology
from repro_torch.kernels.fleet_ingest import fleet_ingest
from repro_torch.kernels.topology_merge import (
    banded_merge_solve,
    from_uv_solve,
    masked_segment_sum_mix,
)


def init_fleet(
    generator: torch.Generator,
    n_devices: int,
    n_features: int,
    n_hidden: int,
    x_init,
    *,
    activation: str = "sigmoid",
    ridge: float = 0.0,
    forget: float = 1.0,
    device: str | torch.device | None = None,
) -> OSELMState:
    """``n_devices`` OS-ELM autoencoders as one stacked state. Every
    device shares one random basis (α, b) drawn from ``generator``;
    ``x_init`` (D, n_init, n_features) holds each device's Eq. 13 boot
    chunk."""
    device = resolve_device(device)
    if n_hidden >= n_features:
        raise ValueError(f"autoencoder needs a bottleneck: Ñ={n_hidden} >= n={n_features}")
    x0 = torch.as_tensor(np.asarray(x_init, np.float32), device=device)
    if x0.shape[0] != n_devices or x0.shape[2] != n_features:
        raise ValueError(f"x_init must be ({n_devices}, n_init, {n_features}); got {tuple(x0.shape)}")
    params = init_slfn(generator, n_features, n_hidden, device=device)
    return init_oselm(params, x0, x0, activation=activation, ridge=ridge, forget=forget)


def fleet_train(states: OSELMState, streams: torch.Tensor) -> OSELMState:
    """Every device runs the k=1 autoencoder steps over its own stream
    (D, T, n), through the fused ingest."""
    return fleet_ingest(states, streams)[0]


def fleet_score(states: OSELMState, x: torch.Tensor) -> torch.Tensor:
    """Per-device anomaly scores (D, k) on shared eval data x (k, n)."""
    y = hidden(states.params, x, states.activation) @ states.beta
    return torch.mean((x - y) ** 2, dim=-1)


def fleet_to_uv(states: OSELMState, *, ridge: float = 0.0) -> UV:
    """Eq. 15 per device: u (D, Ñ, Ñ), v (D, Ñ, m)."""
    return to_uv(states, ridge=ridge)


def _check_nonfinite(nonfinite: str) -> None:
    if nonfinite not in ("error", "repair"):
        raise ValueError(f"nonfinite must be 'error' or 'repair', got {nonfinite!r}")


def fleet_from_uv(
    states: OSELMState, uv: UV, *, ridge: float = 0.0, nonfinite: str = "error"
) -> OSELMState:
    """§4.2 step 5 per device. A non-finite merged (U, V) raises naming
    the devices (``"error"``), or resets those devices to (I, 0)
    (``"repair"``)."""
    _check_nonfinite(nonfinite)
    ok = torch.isfinite(uv.u).all(dim=(1, 2)) & torch.isfinite(uv.v).all(dim=(1, 2))
    if nonfinite == "repair":
        eye = torch.eye(uv.u.shape[-1], dtype=uv.u.dtype, device=uv.u.device)
        keep = ok[:, None, None]
        uv = UV(u=torch.where(keep, uv.u, eye), v=torch.where(keep, uv.v, 0.0))
    elif not bool(ok.all()):
        bad = torch.nonzero(~ok).flatten().tolist()
        raise ValueError(
            f"non-finite merged (U, V) for devices {bad} — a corrupt payload "
            "reached the §4.2 solve; reject it upstream or pass "
            "nonfinite='repair' to reset those devices to (I, 0)"
        )
    return from_uv(states, uv, ridge=ridge)


def _solve_uv(u: torch.Tensor, v: torch.Tensor, ridge: float, nonfinite: str = "error"):
    """One §4.2 step-5 solve (batched over leading axes) with the same
    non-finite guard as ``fleet_from_uv``."""
    _check_nonfinite(nonfinite)
    ok = torch.isfinite(u).flatten(-2).all(-1) & torch.isfinite(v).flatten(-2).all(-1)
    if nonfinite == "repair":
        eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
        keep = ok[..., None, None]
        u, v = torch.where(keep, u, eye), torch.where(keep, v, 0.0)
    elif not bool(ok.all()):
        raise ValueError(
            "non-finite (U, V) reached the §4.2 solve — reject the "
            "corrupt payload upstream or pass nonfinite='repair'"
        )
    return invert_u(u, ridge=ridge), solve_beta(u, v, ridge=ridge)


def _bcast(x: torch.Tensor, n_devices: int) -> torch.Tensor:
    return x[None].expand((n_devices,) + tuple(x.shape))


def _segment_sum(x: torch.Tensor, cids: np.ndarray, n_clusters: int) -> torch.Tensor:
    idx = torch.as_tensor(cids, dtype=torch.long, device=x.device)
    out = torch.zeros((n_clusters,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx, x)


def _mix(topology: Topology, x: torch.Tensor) -> torch.Tensor:
    """out[i] = Σⱼ Mᵢⱼ x[j] for an open ring or a dense mask."""
    if topology.kind == "banded":
        return sum(torch.roll(x, o, dims=0) for o in range(-topology.hops, topology.hops + 1))
    m = torch.as_tensor(topology.matrix, dtype=x.dtype, device=x.device)
    return torch.einsum("ij,j...->i...", m, x)


def _masked_merge_body(
    states: OSELMState, topology: Topology, mask: torch.Tensor, ridge: float
) -> OSELMState:
    """Participation-masked Eq. 8 merge, plain form (Cholesky solves)."""
    uv = fleet_to_uv(states, ridge=ridge)
    mf = mask.to(uv.u.dtype)
    wu = uv.u * mf[:, None, None]
    wv = uv.v * mf[:, None, None]
    n_dev = topology.n_devices

    if topology.kind == "segment":
        su = _segment_sum(wu, topology.cluster_ids, topology.n_clusters)
        sv = _segment_sum(wv, topology.cluster_ids, topology.n_clusters)
        if topology.head_exchange:
            p, beta = _solve_uv(su.sum(0), sv.sum(0), ridge)
            p, beta = _bcast(p, n_dev), _bcast(beta, n_dev)
        else:
            pc, betac = _solve_uv(su, sv, ridge)
            cids = torch.as_tensor(topology.cluster_ids, dtype=torch.long, device=su.device)
            p, beta = pc[cids], betac[cids]
    elif topology.is_fully_connected:
        p, beta = _solve_uv(wu.sum(0), wv.sum(0), ridge)
        p, beta = _bcast(p, n_dev), _bcast(beta, n_dev)
    else:
        merged = fleet_from_uv(states, UV(u=_mix(topology, wu), v=_mix(topology, wv)), ridge=ridge)
        p, beta = merged.p, merged.beta
    return _keep_participants(states, mf, p, beta)


def _keep_participants(states, mf, p, beta) -> OSELMState:
    """Participants take the merged model; the rest keep theirs bit for bit."""
    keep = (mf > 0)[:, None, None]
    return states.replace(
        beta=torch.where(keep, beta, states.beta), p=torch.where(keep, p, states.p)
    )


def fleet_merge_masked(
    states: OSELMState, topology: Topology, mask: torch.Tensor, *, ridge: float = 0.0
) -> OSELMState:
    """Plain masked merge: devices with mask 0 neither contribute their
    (U, V) nor receive the merged model. Use ``ridge > 0`` so a cluster
    with every member masked still solves a well-posed (discarded)
    system."""
    return _masked_merge_body(states, topology, mask, ridge)


def fleet_merge(states: OSELMState, topology: Topology, *, ridge: float = 0.0) -> OSELMState:
    """Plain unmasked merge: every device's merged (U, V) is the Eq. 8
    sum over its neighbour set (self included)."""
    ones = torch.ones(topology.n_devices, dtype=torch.float32, device=states.device)
    return _masked_merge_body(states, topology, ones, ridge)


def fleet_merge_masked_kernel(
    states: OSELMState, topology: Topology, mask: torch.Tensor, *, ridge: float = 0.0
) -> OSELMState:
    """``fleet_merge_masked`` on the merge kernels, f32 payloads.

    Segment topologies gate participation inside the masked segment sum;
    the open ring folds the mask into the payload before the fused
    banded merge+solve; a fully connected merge is a plain sum and one
    Gauss-Jordan solve. A dense topology that is not fully connected
    would need the ``dense_mix`` kernel, which is not ported yet."""
    if topology.kind == "dense" and not topology.is_fully_connected:
        raise NotImplementedError(
            "a dense topology that is not fully connected needs the dense_mix "
            "kernel, which the port does not have yet"
        )
    uv = fleet_to_uv(states, ridge=ridge)
    n = uv.u.shape[-1]
    w = torch.cat([uv.u, uv.v], dim=2)
    mf = mask.to(w.dtype)
    n_dev = topology.n_devices

    if topology.kind == "segment":
        sums = masked_segment_sum_mix(w, topology.cluster_ids, mf, topology.n_clusters)
        if topology.head_exchange:
            total = sums.sum(0, keepdim=True)
            p, beta = from_uv_solve(total[:, :, :n], total[:, :, n:], ridge=ridge)
            p, beta = _bcast(p[0], n_dev), _bcast(beta[0], n_dev)
        else:
            pc, betac = from_uv_solve(sums[:, :, :n], sums[:, :, n:], ridge=ridge)
            cids = torch.as_tensor(topology.cluster_ids, dtype=torch.long, device=w.device)
            p, beta = pc[cids], betac[cids]
    else:
        wm = w * mf[:, None, None]
        if topology.kind == "banded" and not topology.band_closed:
            p, beta = banded_merge_solve(wm, topology.hops, ridge=ridge)
        else:
            total = wm.sum(0, keepdim=True)
            p, beta = from_uv_solve(total[:, :, :n], total[:, :, n:], ridge=ridge)
            p, beta = _bcast(p[0], n_dev), _bcast(beta[0], n_dev)
    return _keep_participants(states, mf, p, beta)
