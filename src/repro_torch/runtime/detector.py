"""Online sequential drift detection over per-tick losses; port of
``repro.runtime.detector`` (``DetectorConfig``, ``DetectorState``,
``init_detector``, ``detector_update``, ``quarantine_risk``).

Per device: ewma_t = (1−α)·ewma_{t−1} + α·loss_t, and drift ⇔
ewma_t > μ_base + k·σ_base, with a Welford calibration window, slow
in-band baseline tracking, hysteresis re-admission and a post-merge
common-mode rebase. The arithmetic follows the reference line by line,
so the flags it raises are the reference's flags. The bank is a set of
(D,) tensors on the fleet's device, updated without a host round trip.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    alpha: float = 0.3
    k_sigma: float = 4.5
    k_readmit: float = 2.0
    k_track: float = 2.0
    warmup: int = 16
    warmup_skip: int = 0
    patience: int = 8
    baseline_alpha: float = 0.02
    min_sigma: float = 1e-6
    rel_sigma: float = 0.0

    def __post_init__(self) -> None:
        if self.warmup_skip < 0:
            raise ValueError(f"need warmup_skip >= 0, got {self.warmup_skip}")
        if self.warmup_skip >= self.warmup:
            raise ValueError(
                f"warmup ({self.warmup}) must exceed warmup_skip "
                f"({self.warmup_skip}): flags would otherwise fire against "
                "an empty (zero-width) calibration band"
            )


@dataclasses.dataclass(frozen=True)
class DetectorState:
    """Per-device detector state; every field is a (D,) tensor."""

    ewma: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor     # int32
    drifted: torch.Tensor   # bool
    recovery: torch.Tensor  # int32

    @property
    def n_devices(self) -> int:
        return self.ewma.shape[0]

    def replace(self, **kw) -> "DetectorState":
        return dataclasses.replace(self, **kw)


def _sigma(state: DetectorState, cfg: DetectorConfig) -> torch.Tensor:
    sigma = torch.sqrt(state.var) + cfg.min_sigma
    return torch.maximum(sigma, cfg.rel_sigma * state.mean)


def init_detector(n_devices: int, *, device: torch.device | str) -> DetectorState:
    z = torch.zeros(n_devices, dtype=torch.float32, device=device)
    zi = torch.zeros(n_devices, dtype=torch.int32, device=device)
    return DetectorState(
        ewma=z, mean=z.clone(), var=z.clone(), count=zi,
        drifted=torch.zeros(n_devices, dtype=torch.bool, device=device),
        recovery=zi.clone(),
    )


def _nanmedian_midpoint(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median of ``values[valid]`` as ``jnp.nanmedian`` takes it: the
    midpoint (lo + hi)·0.5 of the two middle order statistics, NaN when
    nothing is valid. (``torch.nanmedian`` returns the lower one.)"""
    valid = valid & ~torch.isnan(values)
    srt = torch.sort(torch.where(valid, values, torch.inf)).values
    n = valid.sum()
    lo = torch.clamp_min((n - 1) // 2, 0)
    hi = torch.clamp_min(n // 2, 0)
    mid = (srt[lo] + srt[hi]) * 0.5
    return torch.where(n > 0, mid, torch.nan)


def detector_update(
    state: DetectorState,
    losses: torch.Tensor,
    cfg: DetectorConfig,
    *,
    rebase: bool = False,
    participants: torch.Tensor | None = None,
) -> tuple[DetectorState, torch.Tensor, torch.Tensor]:
    """One detection step; returns ``(state', drifted, fresh)``. See the
    reference's docstring for the semantics of ``rebase`` (first tick
    after a merge) and ``participants`` (that merge's mask)."""
    losses = losses.to(torch.float32)
    if participants is None:
        participants = torch.ones_like(losses, dtype=torch.bool)
    participants = participants.to(torch.bool)

    calibrated = state.count >= cfg.warmup
    valid = participants & ~state.drifted & calibrated
    ratio = losses / torch.clamp_min(state.mean, cfg.min_sigma)
    common = _nanmedian_midpoint(ratio, valid)
    common = torch.where(torch.isfinite(common) & (common > 0), common, 1.0)
    do_rebase = valid & bool(rebase)
    state = state.replace(
        mean=torch.where(do_rebase, state.mean * common, state.mean),
        var=torch.where(do_rebase, state.var * common**2, state.var),
        ewma=torch.where(do_rebase, state.ewma * common, state.ewma),
    )

    count = state.count + 1
    warm = state.count < cfg.warmup
    ewma = torch.where(
        state.count <= cfg.warmup_skip, losses,
        (1.0 - cfg.alpha) * state.ewma + cfg.alpha * losses,
    )

    eff_prev = state.count - cfg.warmup_skip
    eff = eff_prev + 1
    skipping = eff_prev < 0
    delta = losses - state.mean
    mean_w = state.mean + delta / torch.clamp_min(eff, 1)
    var_w = torch.clamp_min(
        (state.var * torch.clamp_min(eff_prev, 0) + delta * (losses - mean_w))
        / torch.clamp_min(eff, 1),
        0.0,
    )
    mean_w = torch.where(skipping, state.mean, mean_w)
    var_w = torch.where(skipping, state.var, var_w)

    sigma = _sigma(state, cfg)
    upper = state.mean + cfg.k_sigma * sigma
    readmit_band = state.mean + cfg.k_readmit * sigma

    in_band = ewma <= readmit_band
    track = (~warm) & (~state.drifted) & (losses <= state.mean + cfg.k_track * sigma)
    mean_t = torch.where(
        track, (1 - cfg.baseline_alpha) * state.mean + cfg.baseline_alpha * losses,
        state.mean,
    )
    var_t = torch.where(
        track,
        (1 - cfg.baseline_alpha) * state.var
        + cfg.baseline_alpha * (losses - state.mean) ** 2,
        state.var,
    )
    mean = torch.where(warm, mean_w, mean_t)
    var = torch.where(warm, var_w, var_t)

    fresh = (~warm) & (~state.drifted) & (ewma > upper) & ~do_rebase
    recovery = torch.where(
        state.drifted & in_band, state.recovery + 1, torch.zeros_like(state.recovery)
    )
    readmitted = state.drifted & (recovery >= cfg.patience)
    drifted = (state.drifted | fresh) & ~readmitted
    mean = torch.where(readmitted, ewma, mean)
    recovery = torch.where(readmitted, 0, recovery).to(torch.int32)

    new = DetectorState(
        ewma=ewma, mean=mean, var=var, count=count.to(torch.int32),
        drifted=drifted, recovery=recovery,
    )
    return new, drifted, fresh


def quarantine_risk(state: DetectorState, cfg: DetectorConfig) -> torch.Tensor:
    """(D,) bool — devices whose payloads should not be lossy this round:
    quarantined now, or calibrated and riding above the re-admission
    band μ + k_re·σ. Devices still in warmup are not at risk."""
    calibrated = state.count >= cfg.warmup
    elevated = calibrated & (state.ewma > state.mean + cfg.k_readmit * _sigma(state, cfg))
    return state.drifted | elevated
