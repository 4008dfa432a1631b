"""Fleet telemetry; port of ``repro.obs``.

Structured metrics (``MetricsRegistry``: typed counters / gauges /
histograms with labels, Prometheus-style text exposition), span tracing
(``Tracer``: JSONL trace per run + optional ``torch.profiler``
annotations), and a crash flight recorder (``FlightRecorder``: bounded
ring of recent tick records, dumped to ``flight_<tick>.json`` on
exception, non-finite payload rejection, or SLO breach). A
``TelemetrySink`` composes the three behind the single export surface
the runtime, the serving driver and the benchmarks consume.

Everything is host-side Python updated between kernel launches; the
phase timers synchronize the card at each phase's end so that a phase is
billed its own device work.
"""
from repro_torch.obs.flight import FlightRecorder, jsonable, load_dump
from repro_torch.obs.metrics import (
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    fence,
    phase_timer,
)
from repro_torch.obs.sink import TICK_PHASES, TelemetryConfig, TelemetrySink
from repro_torch.obs.trace import Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "phase_timer", "fence",
    "LATENCY_BUCKETS_S",
    "Tracer",
    "FlightRecorder", "load_dump", "jsonable",
    "TelemetryConfig", "TelemetrySink", "TICK_PHASES",
]
