"""Deterministic fleet fault injection at the payload boundary; port of
``repro.fleet.faults`` (numpy only, so victims, payload operands, crash
masks and poisoned batches are the reference's bit for bit).

Hostile and broken devices are a deployment condition, not a test-only
corner: one device shipping a scaled, poisoned, or non-finite (U, V)
contribution corrupts every Eq. 8 participant in a single merge round.
This module defines the fault model the robustness layer is proven
against, injected at the SAME boundary the wire codec uses — the
stacked published payload ``w = [U | V]`` — so every topology and
backend inherits it without per-path plumbing.

Everything is seed-driven and deterministic: victim selection derives
from ``(seed, spec.seed)`` and per-tick noise from
``(seed, spec.seed, tick)``, so a fault schedule replays identically
across runs, restores, and backends (crash-recovery tests depend on
tick-identical replay).

Fault taxonomy (``FaultSpec.kind``):

- ``sign_flip`` / ``scale`` — multiplicative payload attacks
  (``−magnitude`` / ``magnitude``), the classic Byzantine scaling
  adversary;
- ``noise`` — additive Gaussian payload noise of scale ``magnitude``;
- ``nan`` / ``inf`` — non-finite payloads (broken device, overflow on
  the wire), exercised by the runtime's finite-payload guard;
- ``crash`` — device down for the tick window: excluded from merge
  participation (its local state persists — payload-boundary
  semantics; a revived device rejoins with whatever it learned);
- ``poison`` — the device's *input samples* are replaced with
  deterministic junk of scale ``magnitude`` (data poisoning upstream
  of the payload, attacking through training itself).

``FaultInjector`` resolves specs to concrete victims and exposes the
hooks the runtime calls: ``payload_scale`` (multiplier and non-finite
markers) and ``payload_noise`` (the additive term, None when no noise
schedule is active, so a clean round builds no payload-sized array),
which ``payload_ops`` combines as the reference returns them,
``crash_mask``, and ``poison_batch``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FAULT_KINDS", "FaultInjector", "FaultSpec"]

FAULT_KINDS = ("sign_flip", "scale", "noise", "nan", "inf", "crash", "poison")

_PAYLOAD_KINDS = ("sign_flip", "scale", "noise", "nan", "inf")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault schedule (frozen/hashable so a
    ``ScenarioSpec`` carrying a tuple of these stays a valid cache key).

    Victims are either explicit (``devices``) or a seed-chosen fraction
    of the fleet (``frac`` — at least one device when > 0). The
    schedule is active on ticks ``start_tick <= t < end_tick`` (half
    open; ``None`` = forever), every ``period``-th tick within it."""

    kind: str
    devices: tuple[int, ...] = ()
    frac: float = 0.0
    start_tick: int = 0
    end_tick: int | None = None
    magnitude: float = 1.0
    period: int = 1
    seed: int = 0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; have {FAULT_KINDS}")
        if self.devices and self.frac:
            raise ValueError("give explicit devices OR frac, not both")
        if not self.devices and not self.frac:
            raise ValueError(f"{self.kind!r} fault needs victims: devices or frac")
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError(f"need 0 <= frac <= 1, got {self.frac}")
        if self.period < 1:
            raise ValueError(f"need period >= 1, got {self.period}")
        if self.end_tick is not None and self.end_tick <= self.start_tick:
            raise ValueError(
                f"empty schedule: end_tick {self.end_tick} <= start_tick "
                f"{self.start_tick}"
            )


class FaultInjector:
    """Resolved, replayable fault schedules for one fleet.

    Construction is where randomness happens (victim choice); after
    that every hook is a pure function of ``tick``, so two injectors
    built from the same ``(specs, n_devices, seed)`` produce identical
    fault streams — the property crash-recovery and differential tests
    rely on."""

    def __init__(
        self, specs: tuple[FaultSpec, ...] | list[FaultSpec],
        n_devices: int, *, seed: int = 0,
    ) -> None:
        self.specs = tuple(specs)
        self.n_devices = int(n_devices)
        self.seed = int(seed)
        self._victims: list[np.ndarray] = []
        for spec in self.specs:
            if not isinstance(spec, FaultSpec):
                raise TypeError(f"expected FaultSpec, got {type(spec).__name__}")
            if spec.devices:
                bad = [d for d in spec.devices if not 0 <= d < n_devices]
                if bad:
                    raise ValueError(
                        f"fault devices {bad} out of range for fleet of {n_devices}"
                    )
                victims = np.asarray(sorted(set(spec.devices)), np.int64)
            else:
                k = max(1, round(spec.frac * n_devices))
                rng = np.random.default_rng([self.seed, spec.seed])
                victims = np.sort(rng.choice(n_devices, size=k, replace=False))
            self._victims.append(victims)

    @staticmethod
    def _active(spec: FaultSpec, tick: int) -> bool:
        if tick < spec.start_tick:
            return False
        if spec.end_tick is not None and tick >= spec.end_tick:
            return False
        return (tick - spec.start_tick) % spec.period == 0

    @property
    def byzantine_devices(self) -> tuple[int, ...]:
        """Devices touched by any payload or poison fault (NOT crashes —
        a crashed device is absent, not hostile); evaluation excludes
        these from "honest fleet" AUC summaries."""
        out: set[int] = set()
        for spec, victims in zip(self.specs, self._victims):
            if spec.kind != "crash":
                out.update(int(d) for d in victims)
        return tuple(sorted(out))

    def _active_payload(self, tick: int):
        return [
            (spec, victims) for spec, victims in zip(self.specs, self._victims)
            if spec.kind in _PAYLOAD_KINDS and self._active(spec, tick)
        ]

    def payload_scale(self, tick: int) -> tuple[np.ndarray, np.ndarray]:
        """The tick's multiplicative and non-finite corruption: ``mult``
        (D,) multiplier and ``nonfin`` (D,) int32 markers (0 clean, 1 NaN,
        2 +Inf). Identity (ones, zeros) when nothing is active."""
        mult = np.ones(self.n_devices, np.float32)
        nonfin = np.zeros(self.n_devices, np.int32)
        for spec, victims in self._active_payload(tick):
            if spec.kind == "sign_flip":
                mult[victims] *= -abs(spec.magnitude)
            elif spec.kind == "scale":
                mult[victims] *= spec.magnitude
            elif spec.kind == "nan":
                nonfin[victims] = 1
            elif spec.kind == "inf":
                nonfin[victims] = 2
        return mult, nonfin

    def payload_noise(self, tick: int, shape: tuple[int, ...]) -> np.ndarray | None:
        """The tick's additive (D, R, C) payload noise, or None when no
        noise schedule is active this tick."""
        d, r, c = shape
        if d != self.n_devices:
            raise ValueError(f"payload shape {shape} vs fleet of {self.n_devices}")
        noise = None
        for spec, victims in self._active_payload(tick):
            if spec.kind != "noise":
                continue
            if noise is None:
                noise = np.zeros(shape, np.float32)
            rng = np.random.default_rng([self.seed, spec.seed, tick])
            noise[victims] += spec.magnitude * rng.standard_normal(
                (len(victims), r, c)
            ).astype(np.float32)
        return noise

    def payload_ops(
        self, tick: int, shape: tuple[int, ...]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The tick's payload corruption as three dense operands: ``mult``
        (D,) multiplier, ``noise`` (D, R, C) additive term, ``nonfin``
        (D,) int32 markers (0 clean, 1 NaN, 2 +Inf). Identity
        (ones/zeros/zeros) when nothing is active."""
        noise = self.payload_noise(tick, shape)
        mult, nonfin = self.payload_scale(tick)
        return mult, np.zeros(shape, np.float32) if noise is None else noise, nonfin

    def active_faults(self, tick: int) -> list[tuple[str, int]]:
        """``(kind, victim_count)`` of every schedule active this tick —
        the telemetry layer's fault-event feed (counters + flight
        records), shared with nothing stochastic: pure ``_active``."""
        return [
            (spec.kind, int(len(victims)))
            for spec, victims in zip(self.specs, self._victims)
            if self._active(spec, tick)
        ]

    def crash_mask(self, tick: int) -> np.ndarray:
        """(D,) bool — devices down this tick (merge participation is
        withheld; local state persists until they rejoin)."""
        down = np.zeros(self.n_devices, bool)
        for spec, victims in zip(self.specs, self._victims):
            if spec.kind == "crash" and self._active(spec, tick):
                down[victims] = True
        return down

    def poison_batch(self, batch: np.ndarray, tick: int) -> np.ndarray:
        """Replace active poison victims' sample rows with deterministic
        uniform junk in [−magnitude, magnitude). ``batch`` is the
        (D, per_tick, n_features) host tick window; clean ticks return
        it untouched (same object — zero copies on the hot path)."""
        active = [
            (spec, victims)
            for spec, victims in zip(self.specs, self._victims)
            if spec.kind == "poison" and self._active(spec, tick)
        ]
        if not active:
            return batch
        out = np.array(batch, np.float32, copy=True)
        for spec, victims in active:
            rng = np.random.default_rng([self.seed, spec.seed, tick])
            out[victims] = spec.magnitude * (
                2.0 * rng.random((len(victims),) + out.shape[1:], dtype=np.float32)
                - 1.0
            )
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        kinds = ",".join(s.kind for s in self.specs) or "none"
        return (
            f"FaultInjector(n_devices={self.n_devices}, seed={self.seed}, "
            f"specs=[{kinds}])"
        )
