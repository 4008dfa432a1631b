"""Admission controller — who gets into the next tick window; port of
``repro.serve.admission``.

Every submission gets an explicit decision before it touches a queue:

1. the degraded ladder's SHED / STALE_SCORES rungs answer immediately;
2. a full per-device queue applies the overflow policy (``"defer"``
   asks the client to retry with backoff, ``"shed"`` rejects);
3. a client over its fair-share cap of in-flight requests is deferred
   (one flooding client must not starve the rest — the cap is the
   flood leg's bound);
4. global queue depth near capacity defers (backpressure);
5. a tick-latency p99 over the SLO defers — but only while the queue
   is also non-trivially loaded, so a breach measured during a quiet
   period cannot deadlock admission shut;
6. the governor's comm-budget utilization near its ceiling defers
   (admitting more traffic only grows a queue the merge cadence
   cannot drain).

Decisions are (verdict, reason) so the telemetry shed/deferred
counters record WHY — the benchmark asserts on the reasons.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serve.degraded import Mode
from repro_torch.serve.protocol import SampleRequest

__all__ = ["AdmissionConfig", "AdmissionController", "ADMIT", "DEFER", "SHED", "STALE"]

ADMIT = "admit"
DEFER = "defer"   # retryable: client backs off and resubmits
SHED = "shed"     # rejected outright
STALE = "stale"   # answered from the stale-score cache, not ingested


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    max_queue_per_device: int = 8    # pending requests per device queue
    client_cap: int = 64             # in-flight requests per client
    depth_high_frac: float = 0.9     # global depth fraction that defers
    slo_p99_s: float | None = None   # tick p99 SLO; None = not enforced
    slo_min_depth_frac: float = 0.25  # p99 deferral needs this much load
    budget_defer_frac: float | None = 0.95  # governor budget utilization
                                            # that defers; None = ignore
    overflow: str = "defer"          # "defer" | "shed" on a full device queue

    def __post_init__(self):
        if self.overflow not in ("defer", "shed"):
            raise ValueError(f"overflow must be defer|shed, got {self.overflow!r}")


class AdmissionController:
    """Stateless policy over live pressure signals (the state lives in
    the builder queues, the ladder, and the governor)."""

    def __init__(self, cfg: AdmissionConfig, capacity: int) -> None:
        self.cfg = cfg
        self.capacity = max(capacity, 1)  # global depth ceiling (requests)

    def decide(
        self,
        req: SampleRequest,
        *,
        mode: Mode,
        device_depth: int,
        client_inflight: int,
        total_depth: int,
        tick_p99_s: float | None,
        budget_utilization: float,
    ) -> tuple[str, str]:
        cfg = self.cfg
        if mode >= Mode.SHED:
            return SHED, "degraded"
        if mode >= Mode.STALE_SCORES:
            return STALE, "degraded"
        if device_depth >= cfg.max_queue_per_device:
            if cfg.overflow == "shed":
                return SHED, "queue_full"
            return DEFER, "queue_full"
        if client_inflight >= cfg.client_cap:
            return DEFER, "client_cap"
        depth_frac = total_depth / self.capacity
        if depth_frac >= cfg.depth_high_frac:
            return DEFER, "backpressure"
        if (
            cfg.slo_p99_s is not None
            and tick_p99_s is not None
            and tick_p99_s > cfg.slo_p99_s
            and depth_frac >= cfg.slo_min_depth_frac
        ):
            return DEFER, "slo"
        if (
            cfg.budget_defer_frac is not None
            and budget_utilization >= cfg.budget_defer_frac
        ):
            return DEFER, "comm_budget"
        return ADMIT, "admit"
