"""Byzantine-robust cooperative merges, a bounded-influence Eq. 8; port of
``repro.fleet.robust``.

The paper's cooperative update sums raw (U, V), so one hostile or broken
device corrupts every participant in one round. Three defences act on the
stacked published payload w = [U | V], at the boundary the wire codec
uses:

- **norm clipping** (``payload_clip``): each device's payload is scaled
  by min(1, clip_norm / ‖w‖_F);
- **coordinate-wise trimmed reduction** (``RobustConfig.trim``): each
  neighbourhood sum drops the ``trim`` smallest and largest
  participating values per coordinate and rescales the mean of the rest
  to sum units (``trim=0`` is the plain masked merge, bit for bit);
- **contribution-outlier scores** (``payload_outlier_scores``): the
  Frobenius distance of each device's clipped payload from the
  participants' coordinate-wise median, over the participants' median
  distance. Honest devices score about 1; the governor escalates on
  them (``MergeGovernor.observe_robust``).

Segment topologies (star, hierarchical) and every fully connected one
trim per cluster through the ``robust_segment_sum_mix`` kernel, which
clips as it reads; the open ring trims per ±hops neighbourhood through
an explicit gather and sort; a custom dense mask with ``trim > 0`` raises,
as in the reference. The PSD repair (``torch.linalg.eigh``) and the
solves (Cholesky, ``core.elm``) are plain PyTorch, as the reference runs
them in XLA outside any kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import UV, OSELMState
from repro_torch.core.elm import invert_u, solve_beta
from repro_torch.fleet.fleet import (
    _bcast,
    _masked_kernel_merge_from_w,
    _packed_uv,
    fleet_from_uv,
)
from repro_torch.fleet.topology import Topology
from repro_torch.kernels.robust_merge import robust_segment_combine, robust_segment_sum_mix

__all__ = [
    "RobustConfig",
    "finite_payload_mask",
    "fleet_merge_robust",
    "payload_clip",
    "payload_outlier_scores",
    "robust_merge_from_w",
]

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Robust-merge knobs. ``trim`` and ``clip_norm`` shape the
    aggregation; ``score_threshold`` .. ``readmit_after`` drive the
    governor's robust-score quarantine (strike/calm hysteresis)."""

    clip_norm: float | None = None  # Frobenius clip of w = [U | V]; None = off
    trim: int = 1                   # values trimmed per side per coordinate
    score_threshold: float = 4.0    # outlier score that counts a strike
    score_readmit: float = 2.0      # score below which calm rounds accrue
    escalate_after: int = 2         # consecutive hot rounds → quarantine
    readmit_after: int = 3          # consecutive calm rounds → re-admission

    def __post_init__(self) -> None:
        if self.trim < 0:
            raise ValueError(f"need trim >= 0, got {self.trim}")
        if self.clip_norm is not None and self.clip_norm <= 0:
            raise ValueError(f"need clip_norm > 0, got {self.clip_norm}")
        if self.score_readmit > self.score_threshold:
            raise ValueError(
                "hysteresis needs score_readmit <= score_threshold "
                f"({self.score_readmit} > {self.score_threshold})"
            )
        if self.escalate_after < 1 or self.readmit_after < 1:
            raise ValueError("escalate_after and readmit_after must be >= 1")


def payload_clip(
    w: torch.Tensor, clip_norm: float | None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Per-device Frobenius clip of a stacked payload (D, R, C): returns
    ``(clipped, scale)``, or ``(w, None)`` untouched when clipping is off."""
    if clip_norm is None:
        return w, None
    norms = torch.sqrt(torch.sum(w * w, dim=(1, 2)))
    scale = torch.clamp(clip_norm / torch.clamp(norms, min=_EPS), max=1.0)
    return w * scale[:, None, None], scale


def finite_payload_mask(w: torch.Tensor) -> torch.Tensor:
    """(D,) bool: devices whose whole published payload is finite."""
    return torch.isfinite(w).all(dim=2).all(dim=1)


def nanmedian(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.nanmedian`` along ``dim``: the mean of the two middle non-NaN
    values when their count is even (``torch.nanmedian`` takes the lower
    one), NaN where every value is NaN. NaN sorts last in ``torch.sort``."""
    s = torch.sort(x, dim=dim).values
    count = (~torch.isnan(s)).sum(dim=dim, keepdim=True).to(x.dtype)
    q = 0.5 * (count - 1.0)
    top = torch.clamp(count - 1.0, min=0.0)
    low = torch.clamp(torch.floor(q), min=0.0).minimum(top).long()
    high = torch.clamp(torch.ceil(q), min=0.0).minimum(top).long()
    mid = (torch.gather(s, dim, low) + torch.gather(s, dim, high)) * 0.5
    return mid.squeeze(dim)


def payload_outlier_scores(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Contribution-outlier score of every device (participants or not, so
    a quarantined device's return to normal is observable): the distance
    of its payload from the participants' coordinate-wise median, over the
    participants' median distance; non-finite scores are 0."""
    mf = mask > 0
    sentinel = torch.where(mf[:, None, None], w, torch.nan)
    med = nanmedian(sentinel, 0)
    dist = torch.sqrt(torch.nansum((w - med[None]) ** 2, dim=(1, 2)))
    ref = nanmedian(torch.where(mf, dist, torch.nan), 0)
    scores = dist / (torch.clamp(ref, min=0.0) + _EPS)
    return torch.where(torch.isfinite(scores), scores, 0.0)


def _repair_u(est: torch.Tensor, n: int, eps: float = 1e-4) -> torch.Tensor:
    """PSD repair of the U half of trimmed estimates (..., R, n+m): a
    coordinate-wise trimmed mean of PSD Grams need not be PSD, so
    symmetrise and clamp the spectrum to eps·max(|λ|max, 1)."""
    u = est[..., :, :n]
    u = 0.5 * (u + u.transpose(-1, -2))
    evals, evecs = torch.linalg.eigh(u)
    floor = eps * torch.clamp(evals.abs().amax(dim=-1, keepdim=True), min=1.0)
    evals = torch.maximum(evals, floor)
    u = (evecs * evals[..., None, :]) @ evecs.transpose(-1, -2)
    return torch.cat([u, est[..., :, n:]], dim=-1)


def _solve_uv(u: torch.Tensor, v: torch.Tensor, ridge: float):
    """P = (U+εI)⁻¹ and β = (U+εI)⁻¹V by Cholesky, batched."""
    return invert_u(u, ridge=ridge), solve_beta(u, v, ridge=ridge)


def _robust_segments(
    w: torch.Tensor, scale: torch.Tensor | None, cluster_ids, mask: torch.Tensor,
    n_clusters: int, trim: int,
) -> torch.Tensor:
    """Per-cluster robust sum estimates (n_clusters, R, C); the kernel
    clips each raw payload by ``scale`` as it reads it."""
    d = w.shape[0]
    sc = torch.ones(d, dtype=torch.float32, device=w.device) if scale is None else scale
    tot, lo, hi = robust_segment_sum_mix(w, cluster_ids, mask, sc, n_clusters, trim)
    cids = torch.as_tensor(np.asarray(cluster_ids), dtype=torch.long, device=w.device)
    counts = torch.zeros(n_clusters, dtype=torch.float32, device=w.device)
    counts = counts.index_add(0, cids, mask.to(torch.float32))
    return robust_segment_combine(tot, lo, hi, counts, trim)


def _robust_banded(w: torch.Tensor, mask: torch.Tensor, hops: int, trim: int) -> torch.Tensor:
    """Per-device robust neighbourhood estimates on the open ring: an
    explicit (D, 2·hops+1) neighbour gather, trimmed over the offset
    axis. A band with at most 2·trim participants keeps its plain sum."""
    d = w.shape[0]
    dev = w.device
    idx = (torch.arange(d, device=dev)[:, None]
           + torch.arange(-hops, hops + 1, device=dev)[None, :]) % d
    vals = w[idx]                                   # (D, n_off, R, C)
    mm = mask[idx]                                  # (D, n_off)
    live = (mm > 0)[:, :, None, None]
    tot = torch.sum(torch.where(live, vals, 0.0), dim=1)
    counts = mm.sum(1)
    n_off = 2 * hops + 1
    k = min(trim, n_off)
    lo = torch.sort(torch.where(live, vals, torch.inf), dim=1).values[:, :k]
    hi = torch.sort(torch.where(live, vals, -torch.inf), dim=1).values[:, n_off - k:]
    del vals
    lo = torch.where(torch.isfinite(lo), lo, 0.0).sum(1)
    hi = torch.where(torch.isfinite(hi), hi, 0.0).sum(1)
    live_n = (counts - 2.0 * trim)[:, None, None]
    trimmed = (tot - lo - hi) / torch.clamp(live_n, min=1.0) * counts[:, None, None]
    return torch.where(live_n >= 1.0, trimmed, tot)


def robust_merge_from_w(
    states: OSELMState,
    topology: Topology,
    mask: torch.Tensor,
    w: torch.Tensor,
    cfg: RobustConfig,
    ridge: float,
    *,
    receive: torch.Tensor | None = None,
) -> tuple[OSELMState, torch.Tensor]:
    """Robust participation-masked merge of published payloads ``w``
    (finite: the runtime's guard runs upstream). Returns
    ``(merged_states, outlier_scores)``. Non-participants keep their own
    (P, β), unless ``receive`` widens the download set: a robust-
    quarantined device's payload is distrusted, but it still receives the
    fleet model, which lets its payload re-converge and earn re-admission."""
    n = states.p.shape[-1]
    n_dev = topology.n_devices
    mf = mask.to(device=w.device, dtype=w.dtype)
    w_clip, scale = payload_clip(w, cfg.clip_norm)
    scores = payload_outlier_scores(w_clip, mf)

    if cfg.trim == 0:
        # the clipped payload goes through the exact masked merge; with
        # clipping off this is fleet_merge_masked_kernel bit for bit
        return _masked_kernel_merge_from_w(
            states, topology, mf, w_clip, ridge, receive=receive
        ), scores

    if topology.kind == "segment":
        est = _repair_u(_robust_segments(
            w, scale, topology.cluster_ids, mf, topology.n_clusters, cfg.trim), n)
        if topology.head_exchange:
            # heads exchange their clusters' robust estimates: an attacker
            # is trimmed inside its own cluster before the global sum
            total = est.sum(0)
            p, beta = _solve_uv(total[:, :n], total[:, n:], ridge)
            p, beta = _bcast(p, n_dev), _bcast(beta, n_dev)
        else:
            cids = torch.as_tensor(topology.cluster_ids, dtype=torch.long, device=w.device)
            pc, betac = _solve_uv(est[:, :, :n], est[:, :, n:], ridge)
            p, beta = pc[cids], betac[cids]
    elif topology.is_fully_connected:
        # closed ring or all-ones dense mask: one global segment
        est = _robust_segments(w, scale, np.zeros(n_dev, np.int32), mf, 1, cfg.trim)[0]
        est = _repair_u(est, n)
        p, beta = _solve_uv(est[:, :n], est[:, n:], ridge)
        p, beta = _bcast(p, n_dev), _bcast(beta, n_dev)
    elif topology.kind == "banded":
        est = _repair_u(_robust_banded(w_clip, mf, topology.hops, cfg.trim), n)
        merged = fleet_from_uv(states, UV(u=est[:, :, :n], v=est[:, :, n:]), ridge=ridge)
        p, beta = merged.p, merged.beta
    else:
        raise NotImplementedError(
            "trimmed robust merges need neighbourhood structure (segment, banded "
            "or fully connected); a custom dense mask has none; use trim=0 with "
            f"clipping and outlier scores instead (topology {topology.name!r}, "
            f"trim={cfg.trim})"
        )

    kf = mf if receive is None else receive.to(device=w.device, dtype=mf.dtype)
    keep = (kf > 0)[:, None, None]
    return states.replace(
        beta=torch.where(keep, beta, states.beta), p=torch.where(keep, p, states.p)
    ), scores


def fleet_merge_robust(
    states: OSELMState,
    topology: Topology,
    *,
    config: RobustConfig,
    mask: torch.Tensor | None = None,
    ridge: float = 0.0,
) -> tuple[OSELMState, torch.Tensor]:
    """``fleet_merge_masked_kernel`` with bounded Byzantine influence: clip,
    trim, score. ``RobustConfig(trim=0, clip_norm=None)`` gives
    ``fleet_merge_masked_kernel`` bit for bit."""
    _, w = _packed_uv(states, ridge)
    if mask is None:
        mask = torch.ones(topology.n_devices, dtype=torch.float32, device=w.device)
    return robust_merge_from_w(states, topology, mask, w, config, ridge)
