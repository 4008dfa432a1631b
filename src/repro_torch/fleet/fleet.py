"""Fleet-scale OS-ELM federation on stacked tensors; port of
``repro.fleet.fleet``.

The whole fleet is ONE ``OSELMState`` whose ``beta``/``p`` carry a
leading device axis and whose SLFN basis (α, b) is shared. Training goes
through the fused ingest (``repro_torch.kernels.fleet_ingest``). Every
merge goes through one dispatcher on the merge kernels: the segment sum
(star, hierarchical; masked or not), the fused banded merge+solve (open
ring), the dense mix (any other mask) and the Gauss-Jordan solve. On CPU
tensors the kernels run their plain versions.

- ``fleet_merge_kernel`` (also ``fleet_merge``) — every device merges;
- ``fleet_merge_masked_kernel`` — a participation mask keeps masked-out
  devices out of every neighbour's sum, and they keep their own (P, β)
  bit for bit;
- ``fleet_merge_quantized`` — the stateful lossy round on the same merge:
  payloads published through the int8 ``quantize_pack`` kernel (or f16)
  with error feedback;
- ``fleet_train_rounds`` — the paper's "repeatedly applied to
  synchronize" mode: train a chunk of every stream, merge, repeat.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import UV, OSELMState, from_uv, init_oselm, init_slfn, to_uv
from repro_torch.core.elm import hidden
from repro_torch.fleet.quantize import apply_codec, quantize_roundtrip, validate_precision
from repro_torch.fleet.topology import Topology
from repro_torch.kernels.fleet_ingest import fleet_ingest
from repro_torch.kernels.quantize_pack import dequantize_tiles, quantize_pack
from repro_torch.kernels.topology_merge import (
    banded_merge_solve,
    dense_mix,
    from_uv_solve,
    masked_segment_sum_mix,
    segment_sum_mix,
)

log = logging.getLogger(__name__)


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


def _bcast(x: torch.Tensor, n_devices: int) -> torch.Tensor:
    return x[None].expand((n_devices,) + tuple(x.shape))


def _keep_participants(states, mf, p, beta) -> OSELMState:
    """Participants take the merged model; the rest keep theirs bit for bit."""
    keep = (mf > 0)[:, None, None]
    return states.replace(
        beta=torch.where(keep, beta, states.beta), p=torch.where(keep, p, states.p)
    )


def _masked_kernel_merge_from_w(
    states: OSELMState,
    topology: Topology,
    mask: torch.Tensor | None,
    w: torch.Tensor,
    ridge: float,
    *,
    receive: torch.Tensor | None = None,
) -> OSELMState:
    """The Eq. 8 merge of pre-packed (possibly codec'd) payloads
    w (D, Ñ, Ñ+m) on the merge kernels; ``mask`` None is the unmasked
    merge, in which every device contributes and takes the merged model.

    Segment topologies gate participation inside the masked segment sum
    (or take the plain segment sum without a mask); the other kinds fold
    the mask into the payload first: the open ring goes to the fused
    banded merge+solve, a fully connected merge is a plain sum and one
    Gauss-Jordan solve, and any other dense mask goes through
    ``dense_mix`` and a solve per device. ``receive`` widens the set of
    devices that take the merged model beyond the contributors (None:
    exactly the participants)."""
    n = states.p.shape[-1]
    mf = None if mask is None else mask.to(device=w.device, dtype=w.dtype)
    n_dev = topology.n_devices

    if topology.kind == "segment":
        if mf is None:
            sums = segment_sum_mix(w, topology.cluster_ids, topology.n_clusters)
        else:
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
        wm = w if mf is None else w * mf[:, None, None]
        if topology.kind == "banded" and not topology.band_closed:
            p, beta = banded_merge_solve(wm, topology.hops, ridge=ridge)
        elif topology.is_fully_connected:
            total = wm.sum(0, keepdim=True)
            p, beta = from_uv_solve(total[:, :, :n], total[:, :, n:], ridge=ridge)
            p, beta = _bcast(p[0], n_dev), _bcast(beta[0], n_dev)
        else:
            mixed = dense_mix(wm, topology.dense_matrix())
            p, beta = from_uv_solve(mixed[:, :, :n], mixed[:, :, n:], ridge=ridge)
    if mf is None and receive is None:
        return states.replace(beta=beta.contiguous(), p=p.contiguous())
    kf = mf if receive is None else receive.to(device=w.device, dtype=w.dtype)
    return _keep_participants(states, kf, p, beta)


def _packed_uv(states: OSELMState, ridge: float):
    uv = fleet_to_uv(states, ridge=ridge)
    return uv, torch.cat([uv.u, uv.v], dim=2)


def _one_shot_payloads(states: OSELMState, ridge: float, payload_precision: str) -> torch.Tensor:
    """The packed payloads through the one-shot wire codec (no residual):
    int8 through the ``quantize_pack`` kernel, f16 as a half-precision
    round trip, f32 as they are."""
    validate_precision(payload_precision)
    uv, w = _packed_uv(states, ridge)
    if payload_precision == "int8":
        codes, scales, _ = quantize_pack(uv.u, uv.v)
        return dequantize_tiles(codes, scales)
    return quantize_roundtrip(w, payload_precision)


def fleet_merge_kernel(
    states: OSELMState,
    topology: Topology,
    *,
    ridge: float = 0.0,
    payload_precision: str = "f32",
) -> OSELMState:
    """Topology-aware cooperative update: each device's merged (U, V) is
    the Eq. 8 sum over its neighbour set (itself included), solved once
    per class of identical merged models (one solve when fully connected,
    one per isolated cluster, one per device on an open ring or a custom
    mask). ``payload_precision`` applies the one-shot wire codec to the
    payloads before the mix."""
    w = _one_shot_payloads(states, ridge, payload_precision)
    return _masked_kernel_merge_from_w(states, topology, None, w, ridge)


fleet_merge = fleet_merge_kernel


def fleet_merge_masked_kernel(
    states: OSELMState,
    topology: Topology,
    mask: torch.Tensor,
    *,
    ridge: float = 0.0,
    payload_precision: str = "f32",
) -> OSELMState:
    """The masked Eq. 8 merge: devices with mask 0 neither contribute their
    (U, V) nor receive the merged model. Use ``ridge > 0`` so a cluster
    with every member masked still solves a well-posed (discarded)
    system. ``payload_precision`` applies the one-shot wire codec, as in
    ``fleet_merge_kernel``."""
    w = _one_shot_payloads(states, ridge, payload_precision)
    return _masked_kernel_merge_from_w(states, topology, mask, w, ridge)


def fleet_merge_quantized(
    states: OSELMState,
    topology: Topology,
    *,
    residual: torch.Tensor | None,
    payload_precision: str = "int8",
    ridge: float = 0.0,
    mask: torch.Tensor | None = None,
    fp_mask: torch.Tensor | None = None,
) -> tuple[OSELMState, torch.Tensor | None]:
    """The stateful lossy merge round: every participating device publishes
    its error-feedback-compensated quantized payload, the topology mixes
    the published payloads, and the per-device residuals advance.
    Returns ``(merged_states, residual')``.

    - ``residual`` — (D, Ñ, Ñ+m) backlog from ``init_residual`` (None = a
      zero backlog);
    - ``mask`` — participation, as in ``fleet_merge_masked_kernel`` (None =
      every device); non-participants keep their residual;
    - ``fp_mask`` — devices that ship exact f32 (quarantine risk); their
      residual clears.

    int8 payloads go through the ``quantize_pack`` kernel, f16 payloads
    through a half-precision round trip."""
    validate_precision(payload_precision)
    uv, w = _packed_uv(states, ridge)
    roundtrip = None
    if payload_precision == "int8":
        codes, scales, new_r = quantize_pack(uv.u, uv.v, residual)
        roundtrip = (dequantize_tiles(codes, scales), new_r)
    w_pub, new_resid = apply_codec(
        w, payload_precision, residual=residual, fp_mask=fp_mask,
        participate=mask, roundtrip=roundtrip,
    )
    return _masked_kernel_merge_from_w(states, topology, mask, w_pub, ridge), new_resid


def _streams_on(states: OSELMState, streams) -> torch.Tensor:
    """(D, T, n) streams, a numpy array or a tensor, as f32 on the fleet's
    device."""
    if isinstance(streams, torch.Tensor):
        return streams.to(device=states.p.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(streams, np.float32), device=states.p.device)


def fleet_train_rounds(
    states: OSELMState,
    streams,
    topology: Topology,
    *,
    rounds: int,
    ridge: float = 0.0,
) -> OSELMState:
    """The paper's "repeatedly applied to synchronize" mode at fleet
    scale: cut each (D, T, n) stream into ``rounds`` chunks, train a chunk
    through the fused ingest, merge over the topology
    (``fleet_merge_kernel``), repeat. Synchronous; the lagged variant is
    ``repro_torch.fleet.staleness.fleet_train_async``.

    When ``T % rounds != 0`` the tail ``T % rounds`` samples of every
    stream are dropped (each round trains on ``T // rounds`` samples),
    with a warning."""
    xs = _streams_on(states, streams)
    n_dev, steps, _ = xs.shape
    if not 1 <= rounds <= steps:
        raise ValueError(f"need 1 <= rounds={rounds} <= steps={steps}")
    per = steps // rounds
    tail = steps - rounds * per
    if tail:
        log.warning(
            "fleet_train_rounds: steps=%d not divisible by rounds=%d — "
            "dropping the tail %d samples of every device stream",
            steps, rounds, tail,
        )
    for r in range(rounds):
        states = fleet_train(states, xs[:, r * per : (r + 1) * per].contiguous())
        states = fleet_merge_kernel(states, topology, ridge=ridge)
    return states


def device_state(states: OSELMState, idx: int) -> OSELMState:
    """One device's state sliced out of the stacked fleet (the basis is
    shared, so it is the fleet's)."""
    return states.replace(beta=states.beta[idx], p=states.p[idx])
