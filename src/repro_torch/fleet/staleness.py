"""Async-staleness model for repeated cooperative updates; port of
``repro.fleet.staleness``.

The paper's cooperative update can be "repeatedly applied to
synchronize" devices. In a real fleet the exchanged payloads lag by
transport and queueing delay. Because Eq. 8 is a plain sum, staleness is
modelled exactly by summing lagged versions of the published payloads.

Each round every device

1. trains on its next stream chunk (k=1 sequential steps),
2. publishes its fresh (U, V), version r,
3. merges its OWN fresh (U, V) with each neighbour j's payload of version
   max(0, r − lag[j]), ``lag[j]`` being device j's publication delay in
   rounds.

The published versions live in a ring of packed payloads (L, D, Ñ, Ñ+m),
the layout the merge kernels take; the ring is written in place, one slot
per round. ``lagged_gather`` returns one version per SOURCE device, so the
neighbour term of every device is the topology's mix of one stacked
array: Σ_{j≠i} M_ij·s_j = mix(s)_i − s_i. ``stale_merge_round`` therefore runs
the same sparse kernels as a synchronous merge (``topology_mix``: the
segment sum and broadcast, the banded mix, or the dense mix) in place of
the reference's dense O(D²) product over M − I, and then one
Gauss-Jordan solve per device. The function is the same; the sums round
in another order (f32 rounding, amplified by κ(U) in the solve).

``lag = 0`` everywhere reproduces the synchronous ``fleet_train_rounds``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import OSELMState
from repro_torch.fleet.fleet import _keep_participants, _packed_uv, _streams_on, fleet_train
from repro_torch.fleet.topology import Topology
from repro_torch.kernels.topology_merge import from_uv_solve, topology_mix


@dataclasses.dataclass(frozen=True)
class StalenessSchedule:
    """Per-device publication lags, in merge rounds."""

    lags: np.ndarray  # (D,) int, >= 0

    def __post_init__(self) -> None:
        lags = np.asarray(self.lags)
        if lags.ndim != 1:
            raise ValueError(f"lags must be a (D,) vector, got shape {lags.shape}")
        if lags.size and lags.min() < 0:
            raise ValueError(f"lags must be >= 0, got min {lags.min()}")

    @property
    def max_lag(self) -> int:
        return int(self.lags.max())

    @staticmethod
    def uniform(n_devices: int, lag: int) -> "StalenessSchedule":
        return StalenessSchedule(np.full(n_devices, lag, dtype=np.int32))

    @staticmethod
    def random(
        n_devices: int, max_lag: int, *, seed: int = 0, stragglers: float = 0.0
    ) -> "StalenessSchedule":
        """Lags ~ Uniform{0..max_lag}; a ``stragglers`` fraction of devices
        is pinned to the maximum lag (slow uplinks)."""
        rng = np.random.default_rng(seed)
        lags = rng.integers(0, max_lag + 1, size=n_devices).astype(np.int32)
        n_straggle = int(round(stragglers * n_devices))
        if n_straggle:
            idx = rng.choice(n_devices, size=n_straggle, replace=False)
            lags[idx] = max_lag
        return StalenessSchedule(lags)


def lagged_gather(hist: torch.Tensor, lags, r: int) -> torch.Tensor:
    """hist: (L, D, ...) ring of published versions, slot r % L holding the
    freshest. Returns each source device's payload at version r − lag[j],
    clamped to version 0.

    The ring must hold at least ``max(lags) + 1`` versions: a shorter ring
    would alias version r − lag onto a newer slot and silently serve
    fresher payloads than the schedule claims."""
    lags = np.asarray(lags)
    n_hist = hist.shape[0]
    max_lag = int(lags.max()) if lags.size else 0
    if max_lag >= n_hist:
        raise ValueError(
            f"staleness history holds {n_hist} published versions but the "
            f"schedule lags up to {max_lag} rounds; need history >= "
            f"{max_lag + 1} or the ring aliases fresh payloads"
        )
    slots = np.maximum(r - lags, 0) % n_hist
    rows = torch.as_tensor(slots, dtype=torch.long, device=hist.device)
    return hist[rows, torch.arange(hist.shape[1], device=hist.device)]


def init_ring(states: OSELMState, ridge: float, n_hist: int) -> torch.Tensor:
    """The ring of published versions (L, D, Ñ, Ñ+m), every slot holding
    the fleet's current payloads: the version-0 backfill, so that before a
    device has published its peers see its initial payload, not zeros."""
    _, w0 = _packed_uv(states, ridge)
    return w0[None].repeat(n_hist, 1, 1, 1)


def stale_merge_round(
    states: OSELMState,
    ring: torch.Tensor,
    lags,
    r: int,
    topology: Topology,
    ridge: float,
    *,
    mask: torch.Tensor | None = None,
) -> OSELMState:
    """Merge round r: publish the fleet's fresh payloads as version r (slot
    r % L of ``ring``, written in place; masked-out devices publish too),
    gather each source device's version r − lag, and solve, for device i,
    fresh_i + Σ_{j≠i} M_ij·mf_j·stale_j. That sum is computed as
    (fresh − s) + mix(s) with s = stale·mf formed once: the small
    difference is taken first, so the large neighbour sum is rounded once,
    and with lag 0 (s = fresh) the merged payload is the synchronous mix
    itself. Then one Gauss-Jordan solve per device. ``mask`` (None: every
    device) is the participation mask: a masked-out device contributes to
    no neighbour's sum and keeps its (P, β) bit for bit."""
    n = states.p.shape[-1]
    _, fresh = _packed_uv(states, ridge)
    ring[r % ring.shape[0]] = fresh
    stale = lagged_gather(ring, lags, r)
    mf = None if mask is None else mask.to(device=stale.device, dtype=stale.dtype)
    s = stale if mf is None else stale * mf[:, None, None]
    merged = fresh - s
    merged += topology_mix(s, topology)
    p, beta = from_uv_solve(merged[:, :, :n], merged[:, :, n:], ridge=ridge)
    if mf is None:
        return states.replace(beta=beta, p=p)
    return _keep_participants(states, mf, p, beta)


def fleet_train_async(
    states: OSELMState,
    streams,
    topology: Topology,
    schedule: StalenessSchedule,
    *,
    rounds: int,
    ridge: float = 0.0,
    history: int | None = None,
) -> OSELMState:
    """Round-based fleet training where merges see stale neighbour payloads
    according to ``schedule``. With all-zero lags this is
    ``fleet_train_rounds`` on the same topology (to f32 rounding).

    ``history`` sizes the ring of published versions (default: exactly
    ``max_lag + 1``, the least that holds the schedule). A ring shorter
    than the schedule's lags is an error, not a silent clip."""
    xs = _streams_on(states, streams)
    n_dev, steps, _ = xs.shape
    if n_dev != topology.n_devices or n_dev != len(schedule.lags):
        raise ValueError("device-count mismatch between streams/topology/schedule")
    if not 1 <= rounds <= steps:
        raise ValueError(f"need 1 <= rounds={rounds} <= steps={steps}")
    per = steps // rounds
    n_hist = schedule.max_lag + 1 if history is None else history
    if n_hist <= schedule.max_lag:
        raise ValueError(
            f"history={n_hist} cannot represent lags up to {schedule.max_lag}; "
            f"need history >= {schedule.max_lag + 1}"
        )
    ring = None
    for r in range(rounds):
        states = fleet_train(states, xs[:, r * per : (r + 1) * per].contiguous())
        if ring is None:
            # before anyone has published, peers see the round-0 payloads
            ring = init_ring(states, ridge, n_hist)
        states = stale_merge_round(states, ring, schedule.lags, r, topology, ridge)
    return states
