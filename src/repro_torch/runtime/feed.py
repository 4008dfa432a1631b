"""Tick-batched ingest view over ``FleetStreams``; port of
``repro.runtime.feed`` (numpy only).

The resident runtime consumes per-device streams in fixed-size tick
batches: tick t serves samples [t·B, (t+1)·B) of every device's stream
simultaneously, shaped (D, B, features). ``TickFeed`` is the cursorless
host-side view that deals those slices (a constant shape) and maps the partitioner's step-indexed
``DriftEvent`` schedule onto tick indices so detection delay can be
measured in the same clock the detector runs on.
"""
from __future__ import annotations

import numpy as np

from repro_torch.fleet.partition import FleetStreams


class TickFeed:
    """Deal (D, batch, features) tick batches from a ``FleetStreams``."""

    def __init__(self, streams: FleetStreams, batch: int) -> None:
        if batch < 1:
            raise ValueError(f"need batch >= 1, got {batch}")
        steps = streams.xs.shape[1]
        if batch > steps:
            raise ValueError(f"batch={batch} exceeds stream length {steps}")
        self.streams = streams
        self.batch = batch
        self.n_ticks = steps // batch
        self._warned_truncated = False
        tail = steps - self.n_ticks * batch
        if tail:
            # constant tick shapes: a ragged final batch is dropped
            import logging

            logging.getLogger(__name__).warning(
                "TickFeed: %d trailing samples per stream dropped "
                "(steps=%d not divisible by batch=%d)", tail, steps, batch,
            )

    @property
    def n_devices(self) -> int:
        return self.streams.n_devices

    def tick_batch(self, t: int) -> np.ndarray:
        """Samples every device serves during tick ``t``: (D, B, F)."""
        if not 0 <= t < self.n_ticks:
            raise IndexError(f"tick {t} outside [0, {self.n_ticks})")
        lo = t * self.batch
        return self.streams.xs[:, lo : lo + self.batch]

    def drift_ticks(self) -> dict[int, int]:
        """device -> tick at which its first scheduled drift event lands
        (ground truth for detection-delay accounting).

        Events whose step falls in the truncated tail (``tick >=
        n_ticks``) never reach the runtime, so a device whose drift is
        scheduled *only* there is excluded here — and must be excluded
        from every consumer's denominator too (``truncated_drift_devices``
        is the set ``detection_stats`` needs to stay consistent)."""
        out: dict[int, int] = {}
        for ev in sorted(self.streams.drift, key=lambda e: e.step):
            tick = ev.step // self.batch
            if ev.device not in out and tick < self.n_ticks:
                out[ev.device] = tick
        truncated = self.truncated_drift_devices
        if truncated and not self._warned_truncated:
            self._warned_truncated = True
            import logging

            logging.getLogger(__name__).warning(
                "TickFeed.drift_ticks: drift for device(s) %s is scheduled "
                "entirely past tick %d (the truncated tail) and will never "
                "be served — excluding them from drift ground truth",
                sorted(truncated), self.n_ticks,
            )
        return out

    @property
    def truncated_drift_devices(self) -> frozenset[int]:
        """Devices whose *every* scheduled drift event lands past the
        last full tick: their drift is silently unservable, so detection
        accounting must not count a flag on them as a false positive nor
        their (never-delivered) drift as missed."""
        first_served: set[int] = set()
        scheduled: set[int] = set()
        for ev in self.streams.drift:
            scheduled.add(ev.device)
            if ev.step // self.batch < self.n_ticks:
                first_served.add(ev.device)
        return frozenset(scheduled - first_served)
