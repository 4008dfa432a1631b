"""Fleet-scale OS-ELM federation on stacked tensors; port of
``repro.fleet.fleet``.

The whole fleet is ONE ``OSELMState`` whose ``beta``/``p`` carry a
leading device axis and whose SLFN basis (α, b) is shared. Training goes
through the fused ingest (``repro_torch.kernels.fleet_ingest``). The one
merge is ``fleet_merge_masked_kernel``, on the merge kernels: the masked
segment sum (star, hierarchical), the fused banded merge+solve (open
ring), the dense mix (any other mask) and the Gauss-Jordan solve. On CPU
tensors the kernels run their plain versions.
``fleet_merge_quantized`` is the stateful lossy round on
the same merge: payloads published through the int8 ``quantize_pack``
kernel (or f16) with error feedback.

A participation mask keeps masked-out devices out of every neighbour's
sum, and they keep their own (P, β) bit for bit.
"""
from __future__ import annotations

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
    mask: torch.Tensor,
    w: torch.Tensor,
    ridge: float,
    *,
    receive: torch.Tensor | None = None,
) -> OSELMState:
    """The masked Eq. 8 merge of pre-packed (possibly codec'd) payloads
    w (D, Ñ, Ñ+m) on the merge kernels.

    Segment topologies gate participation inside the masked segment sum;
    the other kinds fold the mask into the payload first: the open ring
    goes to the fused banded merge+solve, a fully connected merge is a
    plain sum and one Gauss-Jordan solve, and any other dense mask goes
    through ``dense_mix`` and a solve per device. ``receive`` widens the
    set of devices that take the merged model beyond the contributors
    (None: exactly the participants)."""
    n = states.p.shape[-1]
    mf = mask.to(device=w.device, dtype=w.dtype)
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
        elif topology.is_fully_connected:
            total = wm.sum(0, keepdim=True)
            p, beta = from_uv_solve(total[:, :, :n], total[:, :, n:], ridge=ridge)
            p, beta = _bcast(p[0], n_dev), _bcast(beta[0], n_dev)
        else:
            mixed = dense_mix(wm, topology.dense_matrix())
            p, beta = from_uv_solve(mixed[:, :, :n], mixed[:, :, n:], ridge=ridge)
    kf = mf if receive is None else receive.to(device=w.device, dtype=w.dtype)
    return _keep_participants(states, kf, p, beta)


def _packed_uv(states: OSELMState, ridge: float):
    uv = fleet_to_uv(states, ridge=ridge)
    return uv, torch.cat([uv.u, uv.v], dim=2)


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
    system. ``payload_precision`` applies the one-shot wire codec (no
    residual) to the payloads before the mix: int8 through the
    ``quantize_pack`` kernel, f16 as a half-precision round trip."""
    validate_precision(payload_precision)
    uv, w = _packed_uv(states, ridge)
    if payload_precision == "int8":
        codes, scales, _ = quantize_pack(uv.u, uv.v)
        w = dequantize_tiles(codes, scales)
    else:
        w = quantize_roundtrip(w, payload_precision)
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
    if mask is None:
        mask = torch.ones(topology.n_devices, dtype=torch.float32, device=w.device)
    return _masked_kernel_merge_from_w(states, topology, mask, w_pub, ridge), new_resid
