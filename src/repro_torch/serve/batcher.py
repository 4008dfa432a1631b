"""Dynamic batcher: admitted requests → constant-shape tick windows;
port of ``repro.serve.batcher``.

The runtime's tick takes a dense ``(D, B, F)`` batch every time (one
shape, so one launch plan a kernel); live traffic is ragged — some devices got several requests this
window, most got none. ``WindowBuilder`` bridges the two: admitted
requests accumulate in per-device FIFO queues, and ``close()`` cuts a
``TickWindow`` that

- takes whole requests per device while their samples fit the ``B``
  budget (a request is never split across ticks — its ack must
  correspond to exactly one tick),
- pads a partially-filled device row by cycling its own taken samples
  (harmless extra k=1 steps on real data from this window),
- pads a completely idle device with its last-known sample (the
  ``fallback`` row) and clears its bit in the ``served`` mask, so the
  runtime's where-merge keeps that device's model and detector state
  bit-for-bit untouched.

The window also records exactly which requests it carries — the unit
of acking, and the unit of write-ahead-log replay after a crash.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.serve.protocol import SampleRequest

__all__ = ["TickWindow", "WindowBuilder"]


@dataclasses.dataclass
class TickWindow:
    """One closed window: the dense batch plus its provenance."""

    seq: int                   # tick number this window is destined for
    batch: np.ndarray          # (D, B, F) dense tick batch
    served: np.ndarray         # (D,) bool — devices carrying real samples
    allow_merge: bool          # degraded skip-merge veto, frozen at close
    requests: list[SampleRequest]  # exactly the requests aboard
    n_samples: int             # real (non-padding) sample rows aboard

    @property
    def n_requests(self) -> int:
        return len(self.requests)


class WindowBuilder:
    """Per-device request queues + deadline-window assembly."""

    def __init__(self, n_devices: int, batch: int, fallback: np.ndarray):
        fallback = np.asarray(fallback, np.float32)
        if fallback.shape[0] != n_devices or fallback.ndim != 2:
            raise ValueError(
                f"fallback must be (n_devices={n_devices}, n_features); "
                f"got {fallback.shape}"
            )
        self.n_devices = n_devices
        self.batch = batch
        self.n_features = fallback.shape[1]
        self.fallback = fallback.copy()
        self.pending: list[deque[SampleRequest]] = [
            deque() for _ in range(n_devices)
        ]
        self.depth = 0  # admitted requests not yet cut into a window

    def device_depth(self, device: int) -> int:
        return len(self.pending[device])

    def can_fit(self, req: SampleRequest) -> bool:
        """Shape admissibility (not load!): the request must be able to
        ride SOME window — device in range, burst within the budget."""
        return (
            0 <= req.device < self.n_devices
            and req.n_samples <= self.batch
            and req.x.shape[1] == self.n_features
        )

    def add(self, req: SampleRequest) -> None:
        if not self.can_fit(req):
            raise ValueError(
                f"request {req.request_id} does not fit: device "
                f"{req.device}/{self.n_devices}, burst {req.n_samples}/"
                f"{self.batch}, features {req.x.shape[1]}/{self.n_features}"
            )
        self.pending[req.device].append(req)
        self.depth += 1

    def close(self, seq: int, *, allow_merge: bool = True) -> TickWindow | None:
        """Cut one window. Returns None when nothing is pending (an
        empty tick is not dispatched — the runtime rejects zero-sample
        batches by contract)."""
        if self.depth == 0:
            return None
        d, b, f = self.n_devices, self.batch, self.n_features
        # Head-blocked scan BEFORE any queue mutation: a head request
        # that alone exceeds the window budget can never ride ANY window
        # (every later close hits the same head), so padding around it
        # would leak it in `depth` forever. Raising pre-mutation keeps
        # the depth invariant exact — no request was popped yet.
        for dev in range(d):
            q = self.pending[dev]
            if q and q[0].n_samples > b:
                head = q[0]
                raise ValueError(
                    f"head-blocked queue on device {dev}: request "
                    f"{head.request_id} carries {head.n_samples} samples "
                    f"but the window budget is {b}; it can never be "
                    f"dispatched (admission via add() caps bursts at the "
                    f"budget — this request bypassed it)"
                )
        batch = np.empty((d, b, f), np.float32)
        served = np.zeros(d, bool)
        taken: list[SampleRequest] = []
        n_samples = 0
        for dev in range(d):
            q = self.pending[dev]
            if not q:
                # idle device: pad with its last-known sample; served
                # stays False so the runtime leaves its state untouched
                batch[dev] = self.fallback[dev]
                continue
            rows: list[np.ndarray] = []
            used = 0
            while q and used + q[0].n_samples <= b:
                req = q.popleft()
                self.depth -= 1
                taken.append(req)
                rows.append(req.x)
                used += req.n_samples
            dense = np.concatenate(rows, axis=0)
            n_samples += used
            if used < b:
                # cycle this window's own samples into the padding rows:
                # extra k=1 steps on data the device legitimately served
                reps = -(-b // used)  # ceil
                dense = np.tile(dense, (reps, 1))[:b]
            batch[dev] = dense
            served[dev] = True
            self.fallback[dev] = dense[used - 1]
        if not taken:
            return None
        return TickWindow(
            seq=seq, batch=batch, served=served,
            allow_merge=allow_merge, requests=taken, n_samples=n_samples,
        )
