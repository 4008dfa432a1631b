"""Non-IID fleet stream partitioner with drift injection; numpy copy of
``repro.fleet.partition``, bit-identical from the same seed.

Builds per-device sample streams from the synthetic datasets
(``repro_torch.data.synthetic``):

- **assignment** — which normal pattern(s) each device observes:
  ``"round_robin"`` (device i sees pattern i mod C, the paper's
  Device-A/B/C setting scaled up) or ``"dirichlet"`` (each device draws
  a pattern mixture ~ Dir(α); small α → near-single-pattern devices,
  large α → near-IID). Dirichlet partitioning is the standard non-IID
  federated benchmark protocol.
- **drift injection** — per-device schedules of concept-drift events:
  at a scheduled step a device's stream switches to a different
  pattern (the scenario the paper's forgetting factor λ and the
  selection hooks exist for). Schedules are explicit and reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np

from repro_torch.data.synthetic import AnomalyDataset


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    """Device ``device`` switches to sampling ``new_pattern`` at
    ``step`` (inclusive) of its stream."""

    device: int
    step: int
    new_pattern: int


class FleetStreams(NamedTuple):
    """Per-device streams + provenance metadata."""

    x_init: np.ndarray        # (D, n_init, features) Eq. 13 init chunks
    xs: np.ndarray            # (D, steps, features) sequential streams
    pattern_of_device: np.ndarray  # (D, steps) int — pattern of each sample
    drift: tuple[DriftEvent, ...]

    @property
    def n_devices(self) -> int:
        return int(self.xs.shape[0])

    @property
    def n_steps(self) -> int:
        return int(self.xs.shape[1])

    def initial_pattern(self, device: int) -> int:
        return int(self.pattern_of_device[device, 0])

    def phase_boundaries(self, device: int) -> tuple[int, ...]:
        """Start steps of ``device``'s concept phases: step 0 (its home
        concept) plus one boundary per scheduled drift event, in stream
        order. Strictly increasing; the scenario layer's validity
        contract (and its hypothesis suite) are written against this."""
        steps = [0]
        for ev in sorted(self.drift, key=lambda e: e.step):
            if ev.device == device and ev.step not in steps:
                steps.append(ev.step)
        return tuple(steps)

    def drifted_devices(self) -> tuple[int, ...]:
        """Devices with at least one scheduled drift event, ascending."""
        return tuple(sorted({ev.device for ev in self.drift}))


def random_drift_schedule(
    n_devices: int,
    steps: int,
    n_classes: int,
    *,
    frac: float = 0.25,
    seed: int = 0,
    home_classes: int | None = None,
    targets: Sequence[int] | None = None,
) -> tuple[DriftEvent, ...]:
    """A ``frac`` fraction of devices drifts once, at a random step in
    the middle half of its stream, to a uniformly-random *other*
    pattern — "other" relative to the round-robin assignment
    (device i starts on pattern i mod C), so no event is a no-op.
    With a single class there is no other pattern to drift to.

    ``home_classes`` restricts the round-robin home assignment to the
    first H classes (matching ``make_fleet_streams(n_assign=H)``), and
    ``targets`` restricts drift destinations — e.g. drift every device
    into a *held-out* pattern so the drifted concept is exactly what
    the fleet's eval protocol labels anomalous."""
    if n_classes < 2:
        raise ValueError("drift needs n_classes >= 2")
    homes = n_classes if home_classes is None else home_classes
    if not 1 <= homes <= n_classes:
        raise ValueError(f"need 1 <= home_classes={homes} <= n_classes={n_classes}")
    rng = np.random.default_rng(seed)
    n_drift = int(round(frac * n_devices))
    devices = rng.choice(n_devices, size=n_drift, replace=False)
    events = []
    for d in devices:
        step = int(rng.integers(steps // 4, max(3 * steps // 4, steps // 4 + 1)))
        current = int(d) % homes
        if targets is None:
            pool = [c for c in range(n_classes) if c != current]
        else:
            pool = [c for c in targets if c != current]
            if not pool:
                raise ValueError(
                    f"no valid drift target for device {d}: targets={targets!r} "
                    f"collapse onto its home pattern {current}"
                )
        new_pat = int(pool[rng.integers(0, len(pool))])
        events.append(DriftEvent(device=int(d), step=step, new_pattern=new_pat))
    return tuple(sorted(events, key=lambda e: (e.device, e.step)))


def _pattern_sequence(
    rng: np.random.Generator,
    device: int,
    steps: int,
    base_probs: np.ndarray,
    drift: Sequence[DriftEvent],
) -> np.ndarray:
    """Per-step pattern ids for one device: mixture draw from
    ``base_probs``, overridden from each drift event's step onward."""
    pats = rng.choice(len(base_probs), size=steps, p=base_probs)
    # apply in step order so a later-step event always wins, whatever
    # order the caller supplied the schedule in
    for ev in sorted(drift, key=lambda e: e.step):
        if ev.device == device:
            pats[ev.step:] = ev.new_pattern
    return pats.astype(np.int32)


def make_fleet_streams(
    ds: AnomalyDataset,
    n_devices: int,
    steps: int,
    *,
    n_init: int = 32,
    assignment: str = "round_robin",
    alpha: float = 0.3,
    drift: Sequence[DriftEvent] = (),
    seed: int = 0,
    n_assign: int | None = None,
) -> FleetStreams:
    """Deal non-IID streams (plus Eq. 13 init chunks) to ``n_devices``
    virtual devices. Init chunks always come from the device's initial
    dominant pattern (a device boots on its own environment).

    ``n_assign`` limits the round-robin home assignment to the first
    ``n_assign`` patterns while drift events may still target ANY
    pattern of ``ds`` — the drift-to-held-out-concept scenario the
    runtime's quarantine benchmark quantifies (trained patterns stay
    {0..n_assign−1}; a drifted device starts serving a pattern the
    eval protocol labels anomalous)."""
    rng = np.random.default_rng(seed)
    n_classes = ds.n_classes
    pools = [ds.pattern(c) for c in range(n_classes)]
    homes = n_classes if n_assign is None else n_assign
    if not 1 <= homes <= n_classes:
        raise ValueError(f"need 1 <= n_assign={homes} <= n_classes={n_classes}")

    if assignment == "round_robin":
        probs = np.zeros((n_devices, n_classes), dtype=np.float64)
        probs[np.arange(n_devices), np.arange(n_devices) % homes] = 1.0
    elif assignment == "dirichlet":
        probs = np.zeros((n_devices, n_classes), dtype=np.float64)
        probs[:, :homes] = rng.dirichlet(np.full(homes, alpha), size=n_devices)
    else:
        raise ValueError(f"unknown assignment {assignment!r}")

    x_init = np.empty((n_devices, n_init, ds.n_features), dtype=np.float32)
    xs = np.empty((n_devices, steps, ds.n_features), dtype=np.float32)
    pattern_of = np.empty((n_devices, steps), dtype=np.int32)
    for d in range(n_devices):
        pats = _pattern_sequence(rng, d, steps, probs[d], drift)
        pattern_of[d] = pats
        init_pat = int(np.argmax(probs[d]))
        pool0 = pools[init_pat]
        x_init[d] = pool0[rng.integers(0, len(pool0), size=n_init)]
        for c in range(n_classes):
            sel = pats == c
            k = int(sel.sum())
            if k:
                pool = pools[c]
                xs[d, sel] = pool[rng.integers(0, len(pool), size=k)]
    return FleetStreams(
        x_init=x_init, xs=xs, pattern_of_device=pattern_of, drift=tuple(drift)
    )
