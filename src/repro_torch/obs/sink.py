"""TelemetrySink — one export surface for the whole serving path; port
of ``repro.obs.sink``.

Owns the three telemetry organs and their output files:

- a ``MetricsRegistry`` pre-declared with the runtime's metric catalog
  (phase latencies, merge bytes by precision, quarantine populations,
  detector band dynamics, fault/nonfinite counters — see README
  "Observability" for the full catalog),
- a ``Tracer`` writing a per-run JSONL trace (optionally mirrored into
  ``torch.profiler.record_function`` scopes),
- a ``FlightRecorder`` ring dumped on exception / non-finite payload /
  SLO breach.

``FleetRuntime``, ``launch/serve.py`` and ``scenarios.evaluate
.run_scenario`` all emit through a sink, and the benchmarks read their
assertions from ``summary()`` — one instrumentation surface, every
consumer. All sink state is host-side Python: enabling telemetry adds no
kernel launch, only the phase fences' synchronizations and a read of
the detector's band every ``band_sample_every`` ticks.

``TelemetryConfig(dir=None)`` keeps everything in memory (no trace
file, no flight dumps, exposition on demand) — cheap enough to leave
on in tests.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import LATENCY_BUCKETS_S, MetricsRegistry, phase_timer
from repro_torch.obs.trace import Tracer

__all__ = ["TelemetryConfig", "TelemetrySink", "TICK_PHASES"]

# the runtime tick's phase decomposition, in execution order;
# "quantize" is the host-side precision-policy step of the quantized
# payload path (the codec itself runs inside the merge); "page_in" /
# "page_out" are the cohort-paged runtime's host↔device transfer phases,
# which the port does not have yet — zero for the resident runtime
TICK_PHASES = (
    "poison", "page_in", "ingest", "page_out", "govern", "quantize",
    "merge", "snapshot",
)

# detector band widths / loss ratios are dimensionless O(1) quantities
_RATIO_BUCKETS = (1e-4, 1e-3, 1e-2, 0.1, 0.3, 1.0, 3.0, 10.0, 100.0)


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Static telemetry knobs (frozen: lives inside ``RuntimeConfig``)."""

    dir: str | None = None            # output dir for trace.jsonl,
                                      # exposition.txt and flight dumps;
                                      # None = in-memory only
    flight_capacity: int = 64         # ring length, in ticks
    max_flight_dumps: int = 4         # total dump budget per run
    slo_tick_seconds: float | None = None  # tick-latency SLO; breach dumps
    trace: bool = True                # write the JSONL span trace
    profiler_annotations: bool = False  # mirror spans into torch.profiler
    sample_cap: int = 4096            # histogram raw-sample window
    band_sample_every: int = 4        # sample the detector band-width /
                                      # loss-ratio histograms every Nth
                                      # tick (they read detector state
                                      # back from the card; 1 = every tick)


class TelemetrySink:
    """Live telemetry state for one runtime (or one serving loop)."""

    def __init__(self, config: TelemetryConfig | None = None) -> None:
        self.config = config or TelemetryConfig()
        cfg = self.config
        self.dir = Path(cfg.dir) if cfg.dir is not None else None
        self.registry = MetricsRegistry()
        self.tracer = Tracer(
            self.dir / "trace.jsonl" if (self.dir and cfg.trace) else None,
            annotations=cfg.profiler_annotations,
        )
        self.flight = FlightRecorder(
            cfg.flight_capacity, max_dumps=cfg.max_flight_dumps
        )

        r, cap = self.registry, cfg.sample_cap
        self.ticks = r.counter("ticks_total", "serving ticks processed")
        self.phase_seconds = r.histogram(
            "tick_phase_seconds", "fenced wall-clock per tick phase",
            labels=("phase",), buckets=LATENCY_BUCKETS_S, sample_cap=cap,
        )
        self.tick_seconds = r.histogram(
            "tick_seconds", "fenced wall-clock of the whole tick",
            buckets=LATENCY_BUCKETS_S, sample_cap=cap,
        )
        self.merge_rounds = r.counter(
            "merge_rounds_total", "admitted cooperative merge rounds"
        )
        self.merge_bytes = r.counter(
            "merge_bytes_total", "merge payload traffic by wire precision",
            labels=("precision",),
        )
        # ---- cohort-paging catalog (the million-device arena runtime;
        # zero-valued for the resident runtime, same registry so both
        # runtimes share one exposition surface)
        self.merge_tier_bytes = r.counter(
            "merge_tier_bytes_total",
            "two-tier merge traffic by tier (intra=within-cohort device "
            "payloads, inter=cohort-head tree payloads)",
            labels=("tier",),
        )
        self.cohort_pages = r.counter(
            "cohort_pages_total", "cohort pages streamed through the device"
        )
        self.arena_bytes = r.gauge(
            "arena_bytes", "host-side fleet arena footprint"
        )
        self.arena_resident_devices = r.gauge(
            "arena_resident_devices",
            "devices whose state is currently staged on the device "
            "(the active cohort window), out of the arena's total",
        )
        self.detections = r.counter(
            "detections_total", "fresh drift-detector flags"
        )
        self.nonfinite = r.counter(
            "nonfinite_payloads_total",
            "payloads rejected by the finite guard",
        )
        self.fault_events = r.counter(
            "fault_events_total", "injected fault activations by kind",
            labels=("kind",),
        )
        self.slo_breaches = r.counter(
            "slo_breaches_total", "ticks over the latency SLO"
        )
        self.flight_dumps = r.counter(
            "flight_dumps_total", "flight-recorder dumps written"
        )
        self.quarantined = r.gauge(
            "quarantined_devices", "drift-quarantined devices"
        )
        self.robust_quarantined = r.gauge(
            "robust_quarantined_devices",
            "devices quarantined by robust-score escalation",
        )
        self.ef_residual_norm = r.gauge(
            "ef_residual_norm", "error-feedback residual Frobenius norm"
        )
        self.band_width = r.histogram(
            "detector_band_width", "calibrated detection band widths k·σ",
            buckets=_RATIO_BUCKETS, sample_cap=cap,
        )
        self.loss_ratio = r.histogram(
            "detector_loss_ratio", "tick loss / baseline mean (calibrated)",
            buckets=_RATIO_BUCKETS, sample_cap=cap,
        )

        # ---- ingress catalog (the async serving front-end's families;
        # pre-declared here so serve-loop state rides the SAME registry
        # snapshot the runtime persists — counters stay continuous
        # across a kill/restore and no benchmark forks its accounting)
        self.ingress_queue_depth = r.gauge(
            "ingress_queue_depth", "admitted requests waiting in windows"
        )
        self.ingress_accepted = r.counter(
            "ingress_accepted_total", "requests admitted into a tick window"
        )
        self.ingress_acked = r.counter(
            "ingress_acked_total", "requests acked with a served result"
        )
        self.ingress_shed = r.counter(
            "ingress_shed_total", "requests shed by reason",
            labels=("reason",),
        )
        self.ingress_deferred = r.counter(
            "ingress_deferred_total", "requests deferred (retryable) by reason",
            labels=("reason",),
        )
        self.ingress_retried = r.counter(
            "ingress_retried_total", "client retries after a deferral"
        )
        self.ingress_stale = r.counter(
            "ingress_stale_served_total",
            "requests answered from the stale-score cache (degraded)",
        )
        self.ingress_replayed = r.counter(
            "ingress_replayed_ticks_total",
            "tick windows replayed from the write-ahead log on recovery",
        )
        self.ingress_degraded_mode = r.gauge(
            "ingress_degraded_mode",
            "current degraded-ladder rung (0=normal 1=skip-merge "
            "2=stale-scores 3=shed)",
        )
        self.ingress_transitions = r.counter(
            "ingress_degraded_transitions_total",
            "degraded-ladder transitions by target mode",
            labels=("mode",),
        )
        self.ingress_admission_seconds = r.histogram(
            "ingress_admission_seconds",
            "submit-to-admission-decision latency",
            buckets=LATENCY_BUCKETS_S, sample_cap=cap,
        )
        self.ingress_request_seconds = r.histogram(
            "ingress_request_seconds",
            "submit-to-ack latency of served requests",
            buckets=LATENCY_BUCKETS_S, sample_cap=cap,
        )
        # bound observe callables once — phase() sits on the tick path
        self._phase_observe = {
            p: self.phase_seconds.labels(phase=p).observe for p in TICK_PHASES
        }

    # ---------------------------------------------------------------- timing

    def phase(self, name: str):
        """Context manager timing one tick phase into the phase
        histogram (``handle.fence(tree)`` fences before the read)."""
        observe = self._phase_observe.get(name)
        if observe is None:
            raise ValueError(f"unknown phase {name!r}; have {TICK_PHASES}")
        return phase_timer(observe)

    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    # --------------------------------------------------------------- flight

    def maybe_dump(self, tick: int, reason: str, *, inputs=None,
                   extra: dict | None = None):
        """Rate-limited flight dump; no-op without an output dir."""
        if self.dir is None:
            return None
        path = self.flight.dump(
            self.dir, tick, reason, inputs=inputs, extra=extra
        )
        if path is not None:
            self.flight_dumps.inc()
            self.tracer.emit({"name": "flight_dump", "tick": int(tick),
                              "reason": reason, "path": str(path)})
        return path

    # --------------------------------------------------------------- export

    def phase_stats(self) -> dict[str, dict]:
        """Per-phase latency stats (seconds) over the retained window."""
        out = {}
        for phase in TICK_PHASES:
            h = self.phase_seconds.children.get((phase,))
            if h is None or h.count == 0:
                continue
            out[phase] = {
                "count": h.count,
                "mean_s": h.sum / h.count,
                "p50_s": h.quantile(0.50),
                "p99_s": h.quantile(0.99),
                "max_s": h.vmax,
            }
        return out

    def bytes_by_precision(self) -> dict[str, int]:
        return {
            key[0]: int(child.value)
            for key, child in sorted(self.merge_bytes.children.items())
        }

    def ingress_stats(self) -> dict:
        """The serving front-end's view: admission outcomes, queue
        depth, degraded-ladder position, and submit-to-ack latency."""
        def _latency(h):
            if h.count == 0:
                return None
            return {
                "count": h.count,
                "mean_s": h.sum / h.count,
                "p50_s": h.quantile(0.50),
                "p99_s": h.quantile(0.99),
                "max_s": h.vmax,
            }

        return {
            "accepted": int(self.ingress_accepted.value),
            "acked": int(self.ingress_acked.value),
            "retried": int(self.ingress_retried.value),
            "stale_served": int(self.ingress_stale.value),
            "replayed_ticks": int(self.ingress_replayed.value),
            "queue_depth": int(self.ingress_queue_depth.value),
            "shed": {
                key[0]: int(child.value)
                for key, child in sorted(self.ingress_shed.children.items())
            },
            "deferred": {
                key[0]: int(child.value)
                for key, child in sorted(self.ingress_deferred.children.items())
            },
            "degraded_mode": int(self.ingress_degraded_mode.value),
            "degraded_transitions": {
                key[0]: int(child.value)
                for key, child in sorted(self.ingress_transitions.children.items())
            },
            "admission_latency": _latency(self.ingress_admission_seconds),
            "request_latency": _latency(self.ingress_request_seconds),
        }

    def summary(self) -> dict:
        """End-of-run summary dict — the one surface benchmarks consume."""
        t = self.tick_seconds
        return {
            "ticks": int(self.ticks.value),
            "merge_rounds": int(self.merge_rounds.value),
            "bytes_by_precision": self.bytes_by_precision(),
            "bytes_total": sum(self.bytes_by_precision().values()),
            "detections_total": int(self.detections.value),
            "nonfinite_payloads_total": int(self.nonfinite.value),
            "slo_breaches_total": int(self.slo_breaches.value),
            "fault_events": {
                key[0]: int(child.value)
                for key, child in sorted(self.fault_events.children.items())
            },
            "tick_latency": None if t.count == 0 else {
                "count": t.count,
                "mean_s": t.sum / t.count,
                "p50_s": t.quantile(0.50),
                "p99_s": t.quantile(0.99),
                "max_s": t.vmax,
            },
            "phases": self.phase_stats(),
            "ingress": self.ingress_stats(),
            "flight": {
                "recorded": self.flight.records_total,
                "ring_len": len(self.flight),
                "dumps": list(self.flight.dumps),
            },
            "metrics": self.registry.summary(),
        }

    def exposition(self) -> str:
        return self.registry.exposition()

    def write_outputs(self) -> None:
        """Flush the trace and write the text exposition (dir mode)."""
        self.tracer.flush()
        if self.dir is not None:
            self.dir.mkdir(parents=True, exist_ok=True)
            (self.dir / "exposition.txt").write_text(self.exposition())

    def close(self) -> None:
        self.write_outputs()
        self.tracer.close()

    # ------------------------------------------------------------- snapshot

    def state(self) -> dict:
        """JSON-able restorable state: registry + flight ring."""
        return {"registry": self.registry.state(),
                "flight": self.flight.state()}

    def load_state(self, state: dict) -> None:
        self.registry.load_state(state.get("registry", {}))
        self.flight.load_state(state.get("flight", {}))

    def state_bytes(self) -> bytes:
        return json.dumps(self.state()).encode()

    def load_state_bytes(self, raw: bytes) -> None:
        self.load_state(json.loads(bytes(raw).decode()))
