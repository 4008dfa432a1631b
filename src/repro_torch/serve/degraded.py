"""Degraded-mode ladder — load shedding as policy, not accident; port of
``repro.serve.degraded``.

Four rungs, ordered by how much of the serving contract they give up:

- ``NORMAL``       — full service: train, score, merge on cadence
- ``SKIP_MERGE``   — ticks still train and score, but cooperative
                     merges are vetoed (``allow_merge=False``); sheds
                     the most expensive tick phase first
- ``STALE_SCORES`` — new requests are answered from the device's last
                     known score without training; the runtime only
                     drains already-admitted windows
- ``SHED``         — new requests are rejected outright

A watchdog evaluates pressure once per closed window: a stalled tick
(worker stuck past the deadline), a tick-latency p99 over the SLO (the
telemetry sink's tick timer), or queue depth near capacity. Escalation needs
``escalate_after`` consecutive pressured checks and recovery
``recover_after`` consecutive calm ones — the same hysteresis shape as
the drift detector's quarantine/re-admission, for the same reason: a
single slow tick must not flap the fleet in and out of degraded
service.
"""
from __future__ import annotations

import dataclasses
import enum

__all__ = ["Mode", "LadderConfig", "DegradedLadder"]


class Mode(enum.IntEnum):
    NORMAL = 0
    SKIP_MERGE = 1
    STALE_SCORES = 2
    SHED = 3


@dataclasses.dataclass(frozen=True)
class LadderConfig:
    escalate_after: int = 2   # consecutive pressured checks per rung up
    recover_after: int = 4    # consecutive calm checks per rung down


class DegradedLadder:
    """Hysteresis state machine over ``Mode``."""

    def __init__(self, cfg: LadderConfig | None = None) -> None:
        self.cfg = cfg or LadderConfig()
        self.mode = Mode.NORMAL
        self.pressured_checks = 0
        self.calm_checks = 0
        self.transitions: list[tuple[int, Mode]] = []  # (check_no, new mode)
        self._checks = 0

    def check(self, pressured: bool) -> Mode:
        """Fold one watchdog observation; returns the (possibly new)
        mode. One rung per transition — pressure during SKIP_MERGE
        escalates to STALE_SCORES, not straight to SHED."""
        self._checks += 1
        if pressured:
            self.pressured_checks += 1
            self.calm_checks = 0
            if (
                self.pressured_checks >= self.cfg.escalate_after
                and self.mode < Mode.SHED
            ):
                self.mode = Mode(self.mode + 1)
                self.pressured_checks = 0
                self.transitions.append((self._checks, self.mode))
        else:
            self.calm_checks += 1
            self.pressured_checks = 0
            if (
                self.calm_checks >= self.cfg.recover_after
                and self.mode > Mode.NORMAL
            ):
                self.mode = Mode(self.mode - 1)
                self.calm_checks = 0
                self.transitions.append((self._checks, self.mode))
        return self.mode
