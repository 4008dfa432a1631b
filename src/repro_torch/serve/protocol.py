"""Request/ack protocol of the async serving front-end; port of
``repro.serve.protocol``.

One ``SampleRequest`` is one client's sample burst for one device: up
to a tick window's per-device budget of feature rows. The front-end
answers every submission with exactly one ``Ack`` — immediately for
shed/busy outcomes, after the tick that trained on the samples for
admitted ones. The ack carries the drift-signal score (the device's
mean ae_score of the batch it rode in) so a client sees the same
number the runtime's TickReport records. A request's samples stay a
numpy array on the host: the runtime moves each tick's batch to its
device.

Statuses:

- ``ok``      — admitted, trained, scored in the ack'd tick
- ``stale``   — answered from the last known score without training
                (the STALE_SCORES degraded rung); samples NOT ingested
- ``shed``    — rejected outright (queue full under a shed policy, or
                the SHED degraded rung); safe to retry later
- ``busy``    — deferred by backpressure; retry with backoff
                (``submit_with_retries`` automates this)
- ``failed``  — the tick that carried the request raised
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

__all__ = ["SampleRequest", "Ack", "request_id"]

_ids = itertools.count()


def request_id() -> int:
    """Process-unique monotonically increasing request id."""
    return next(_ids)


@dataclasses.dataclass(frozen=True)
class SampleRequest:
    """One client's sample burst for one device."""

    device: int
    x: np.ndarray          # (k, n_features) sample rows, k >= 1
    client: str = "anon"   # fair-share accounting key
    request_id: int = dataclasses.field(default_factory=request_id)

    def __post_init__(self):
        x = np.asarray(self.x, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[0] < 1:
            raise ValueError(
                f"request samples must be (k, n_features) with k>=1; "
                f"got shape {np.asarray(self.x).shape}"
            )
        object.__setattr__(self, "x", x)

    @property
    def n_samples(self) -> int:
        return self.x.shape[0]


@dataclasses.dataclass(frozen=True)
class Ack:
    """The front-end's single, final answer to one submission."""

    request_id: int
    status: str                  # "ok" | "stale" | "shed" | "busy" | "failed"
    tick: int | None = None      # tick that served it (ok), else None
    score: float | None = None   # device mean ae_score (ok/stale)
    drifted: bool | None = None  # device quarantine flag after the tick
    attempts: int = 1            # submissions incl. retries (retry helper)
    latency_s: float | None = None  # submit-to-ack wall clock
    reason: str | None = None    # shed/busy cause, or the tick's error

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def retryable(self) -> bool:
        return self.status in ("busy", "shed")
