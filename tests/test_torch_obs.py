"""The port's telemetry (``repro_torch.obs``) against the reference's
``repro.obs``, on the CPU.

The reference's unit tests of ``tests/test_obs.py`` (registry, histogram
edges and ``observe_many``, exposition, state round trips, the tracer's
JSONL, the flight ring and its dump rate limit, ``load_dump``, the
sink's ingress block) run here on the port's modules; the phase fence
synchronizes the CUDA devices of the tensors it is handed (none here).

On ``test_obs.py``'s ``obs_scenario`` fixture (8 devices, 60 ticks, two
drifting), with the reference's initial fleet carried across by
``repro_torch.convert``, the port's ``TelemetrySink.summary()`` has the
reference's keys at every level and the reference's counts (ticks,
merge rounds, bytes by precision, detections, non-finite payloads, fault
events); timings are checked by type and sign only, as the two packages'
clocks measure different code. The reports are the same with telemetry
on and off, and the NaN fault's flight dump holds the failing tick's
post-poison batch and ends at that tick, as the reference's
``test_runtime_flight_dump_on_nan_payload`` checks.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.data import make_har_dataset
from repro.data.pipeline import train_test_split
from repro.data.synthetic import AnomalyDataset
from repro.fleet import DriftEvent, init_fleet, make_fleet_streams
from repro.fleet import ring as ref_ring
from repro.fleet.faults import FaultInjector as RefFaultInjector
from repro.fleet.faults import FaultSpec as RefFaultSpec
from repro.fleet.robust import RobustConfig as RefRobustConfig
from repro.obs import TelemetryConfig as RefTelemetryConfig
from repro.runtime import DetectorConfig as RefDetectorConfig
from repro.runtime import FleetRuntime as RefRuntime
from repro.runtime import GovernorConfig as RefGovernorConfig
from repro.runtime import RuntimeConfig as RefRuntimeConfig
from repro.runtime import TickFeed as RefTickFeed
from repro_torch.convert import oselm_state_from_numpy
from repro_torch.fleet import FaultInjector, FaultSpec, RobustConfig, ring
from repro_torch.obs import (
    TICK_PHASES,
    Counter,
    FlightRecorder,
    Histogram,
    MetricsRegistry,
    TelemetryConfig,
    TelemetrySink,
    Tracer,
    fence,
    load_dump,
    phase_timer,
)
from repro_torch.runtime import DetectorConfig, FleetRuntime, GovernorConfig, RuntimeConfig
from repro_torch.runtime import TickFeed

torch.set_num_threads(2)

RIDGE = 1e-3
H_RT = 16

# ------------------------------------------------------------------- metrics


def test_counter_monotone():
    c = Counter()
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    assert c.value == 3.5


def test_histogram_bucket_edges_are_inclusive_upper_bounds():
    h = Histogram(buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.5, 2.0, 4.0, 100.0):
        h.observe(v)
    assert h.counts == [2, 2, 1, 1]  # le=1, le=2, le=4, +Inf
    assert h.count == 6
    assert h.vmin == 0.5 and h.vmax == 100.0
    assert h.sum == pytest.approx(109.0)


def test_histogram_rejects_bad_edges():
    for edges in ((), (1.0, 1.0, 2.0), (2.0, 1.0)):
        with pytest.raises(ValueError):
            Histogram(buckets=edges)


def test_histogram_observe_many_matches_sequential_observe():
    values = np.random.default_rng(0).gamma(1.0, 2.0, size=257)
    one = Histogram(buckets=(0.5, 1.0, 2.0, 8.0), sample_cap=100)
    many = Histogram(buckets=(0.5, 1.0, 2.0, 8.0), sample_cap=100)
    for v in values:
        one.observe(v)
    many.observe_many(values)
    assert one.counts == many.counts and one.count == many.count
    assert one.sum == pytest.approx(many.sum)
    assert list(one.samples) == pytest.approx(list(many.samples))
    assert one.quantile(0.5) == pytest.approx(many.quantile(0.5))


def test_histogram_sample_window_is_bounded():
    h = Histogram(buckets=(1.0,), sample_cap=8)
    h.observe_many(np.arange(100, dtype=np.float64))
    assert list(h.samples) == list(range(92, 100))
    assert h.count == 100


def test_registry_labels_and_redeclare():
    r = MetricsRegistry()
    fam = r.counter("merge_bytes_total", labels=("precision",))
    fam.labels(precision="f32").inc(100)
    fam.labels(precision="int8").inc(25)
    assert fam.labels(precision="f32").value == 100
    assert r.counter("merge_bytes_total", labels=("precision",)) is fam
    with pytest.raises(ValueError):
        r.gauge("merge_bytes_total")
    with pytest.raises(ValueError):
        fam.labels(wrong="x")
    with pytest.raises(ValueError):
        r.counter("bad name!")


def test_registry_exposition_well_formed():
    r = MetricsRegistry()
    r.counter("ticks_total", "ticks").inc(5)
    r.gauge("quarantined_devices").set(2)
    h = r.histogram("lat_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 10.0):
        h.observe(v)
    text = r.exposition()
    for line in ("# TYPE ticks_total counter", "ticks_total 5", "# TYPE quarantined_devices gauge",
                 "# TYPE lat_seconds histogram", 'lat_seconds_bucket{le="0.1"} 1',
                 'lat_seconds_bucket{le="1"} 2', 'lat_seconds_bucket{le="+Inf"} 3',
                 "lat_seconds_count 3"):
        assert line in text


def test_registry_state_roundtrip():
    r = MetricsRegistry()
    r.counter("ticks_total").inc(7)
    r.gauge("level").set(-1.5)
    r.counter("bytes_total", labels=("precision",)).labels(precision="f32").inc(64)
    h = r.histogram("lat", buckets=(1.0, 2.0))
    h.observe_many([0.5, 1.5, 9.0])
    state = json.loads(json.dumps(r.state()))
    r2 = MetricsRegistry()
    r2.counter("ticks_total")
    r2.gauge("level")
    r2.counter("bytes_total", labels=("precision",))
    r2.histogram("lat", buckets=(1.0, 2.0))
    r2.load_state(state)
    assert r2.counter("ticks_total").value == 7
    assert r2.gauge("level").value == -1.5
    assert r2.counter("bytes_total", labels=("precision",)).labels(precision="f32").value == 64
    h2 = r2.histogram("lat", buckets=(1.0, 2.0))
    assert h2.counts == h.counts and h2.count == 3
    assert h2.quantile(0.5) == h.quantile(0.5)


def test_registry_load_rejects_bucket_mismatch():
    r = MetricsRegistry()
    r.histogram("lat", buckets=(1.0, 2.0)).observe(0.5)
    r2 = MetricsRegistry()
    r2.histogram("lat", buckets=(1.0, 4.0))
    with pytest.raises(ValueError):
        r2.load_state(r.state())


def test_phase_timer_fences_tensors():
    seen = []
    with phase_timer(seen.append) as handle:
        handle.fence({"x": torch.ones(64, 64) @ torch.ones(64, 64), "n": [torch.zeros(2)]})
    assert len(seen) == 1 and seen[0] > 0
    with phase_timer(seen.append):
        pass
    assert len(seen) == 2
    # the fence walks dataclasses too; CPU tensors need no synchronize
    fence(RuntimeConfig(topology=ring(4)))


# --------------------------------------------------------------------- trace


def test_tracer_writes_parseable_jsonl(tmp_path):
    path = tmp_path / "trace.jsonl"
    tr = Tracer(path)
    with tr.span("merge", tick=3):
        pass
    tr.emit({"name": "flight_dump", "tick": 3})
    tr.close()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert [e["name"] for e in events] == ["merge", "flight_dump"]
    assert events[0]["tick"] == 3 and events[0]["dur_s"] >= 0
    assert tr.events_emitted == 2


def test_tracer_disabled_is_noop_and_annotations_profile():
    tr = Tracer(None)
    assert not tr.enabled
    with tr.span("x"):
        pass
    assert tr.events_emitted == 0
    ann = Tracer(None, annotations=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with ann.span("ingest", tick=0):
            torch.ones(4).sum()
    assert any(e.key == "ingest" for e in prof.key_averages())
    assert ann.events_emitted == 1


# -------------------------------------------------------------------- flight


def test_flight_ring_bounded():
    fr = FlightRecorder(capacity=4)
    for t in range(10):
        fr.record({"tick": t})
    assert len(fr) == 4 and fr.records_total == 10
    assert [r["tick"] for r in fr.records()] == [6, 7, 8, 9]


def test_flight_dump_roundtrip_and_rate_limit(tmp_path):
    fr = FlightRecorder(capacity=8, max_dumps=2)
    fr.record({"tick": 0, "losses": np.asarray([1.0, 2.0], np.float32), "n": np.int64(3)})
    inputs = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    path = fr.dump(tmp_path, 0, "nonfinite", inputs=inputs, extra={"count": np.int32(2)})
    dump = load_dump(path)
    assert dump["reason"] == "nonfinite"
    assert dump["ring"][0]["losses"] == [1.0, 2.0]
    assert dump["extra"]["count"] == 2
    np.testing.assert_array_equal(dump["inputs"], inputs)
    assert dump["inputs"].dtype == np.float32
    assert fr.dump(tmp_path, 1, "nonfinite") is not None  # budget: 2
    assert fr.dump(tmp_path, 2, "nonfinite") is None      # over budget
    assert fr.dump(tmp_path, 3, "slo") is not None        # a new reason always dumps once
    assert len(fr.dumps) == 3


def test_flight_state_roundtrip():
    fr = FlightRecorder(capacity=4, max_dumps=1)
    for t in range(6):
        fr.record({"tick": t})
    fr2 = FlightRecorder(capacity=4)
    fr2.load_state(json.loads(json.dumps(fr.state())))
    assert fr2.records() == fr.records() and fr2.records_total == 6


# ---------------------------------------------------------------------- sink


def test_sink_rejects_unknown_phase_and_keeps_the_reference_phases():
    from repro.obs import TICK_PHASES as REF_PHASES

    assert TICK_PHASES == REF_PHASES
    sink = TelemetrySink(TelemetryConfig())
    with pytest.raises(ValueError):
        sink.phase("warp")
    with sink.phase("ingest"):
        pass
    assert sink.phase_seconds.labels(phase="ingest").count == 1


def test_sink_ingress_stats_in_summary():
    sink = TelemetrySink(TelemetryConfig(trace=False))
    sink.ingress_accepted.inc(5)
    sink.ingress_acked.inc(4)
    sink.ingress_retried.inc(2)
    sink.ingress_stale.inc()
    sink.ingress_shed.labels(reason="queue_full").inc(3)
    sink.ingress_deferred.labels(reason="backpressure").inc(2)
    sink.ingress_deferred.labels(reason="comm_budget").inc()
    sink.ingress_degraded_mode.set(2)
    sink.ingress_transitions.labels(mode="stale_scores").inc()
    sink.ingress_request_seconds.observe(0.004)
    sink.ingress_request_seconds.observe(0.019)
    ing = sink.summary()["ingress"]
    assert ing["accepted"] == 5 and ing["acked"] == 4
    assert ing["retried"] == 2 and ing["stale_served"] == 1
    assert ing["shed"] == {"queue_full": 3}
    assert ing["deferred"] == {"backpressure": 2, "comm_budget": 1}
    assert ing["degraded_mode"] == 2
    assert ing["degraded_transitions"] == {"stale_scores": 1}
    assert ing["request_latency"]["count"] == 2 and ing["request_latency"]["p99_s"] > 0
    assert ing["admission_latency"] is None


def test_sink_state_bytes_roundtrip():
    sink = TelemetrySink(TelemetryConfig(trace=False))
    sink.ingress_accepted.inc(7)
    sink.ingress_shed.labels(reason="degraded").inc(2)
    sink.ingress_replayed.inc(3)
    sink.ticks.inc(4)
    sink.flight.record({"tick": 3})
    sink2 = TelemetrySink(TelemetryConfig(trace=False))
    sink2.load_state_bytes(sink.state_bytes())
    ing = sink2.ingress_stats()
    assert ing["accepted"] == 7 and ing["shed"] == {"degraded": 2}
    assert ing["replayed_ticks"] == 3
    assert int(sink2.ticks.value) == 4 and sink2.flight.records() == [{"tick": 3}]


def test_sink_writes_its_outputs(tmp_path):
    sink = TelemetrySink(TelemetryConfig(dir=str(tmp_path / "tel")))
    with sink.span("merge", tick=1):
        sink.merge_rounds.inc()
    sink.close()
    assert "merge_rounds_total 1" in (tmp_path / "tel" / "exposition.txt").read_text()
    (event,) = [json.loads(x) for x in (tmp_path / "tel" / "trace.jsonl").read_text().splitlines()]
    assert event["name"] == "merge" and event["tick"] == 1


# ---------------------------------------------------------- sink + runtime


def _har3():
    ds = make_har_dataset(seed=0, samples_per_class=100)
    lo, hi = ds.x.min(0), ds.x.max(0)
    ds = ds._replace(x=((ds.x - lo) / (hi - lo + 1e-6)).astype(np.float32))
    train, _ = train_test_split(ds, 0.8, seed=0)
    m = train.y < 3
    return AnomalyDataset(train.name, train.x[m], train.y[m], train.class_names[:3])


@pytest.fixture(scope="module")
def obs_scenario():
    """test_obs.py's fixture: 8 devices, 60 ticks, 2 drifting mid-soak."""
    train3 = _har3()
    ticks, batch = 60, 2
    drift = tuple(DriftEvent(device=d, step=60 + 11 * i, new_pattern=2)
                  for i, d in enumerate((2, 5)))
    fs = make_fleet_streams(train3, 8, ticks * batch, n_init=2 * H_RT, drift=drift, seed=0,
                            n_assign=2)
    fleet = init_fleet(jax.random.PRNGKey(0), fs.n_devices, train3.n_features, H_RT, fs.x_init,
                       activation="identity", ridge=RIDGE)
    return fs, batch, fleet


def _reference(obs_scenario, **kw):
    fs, _, fleet = obs_scenario
    kw.setdefault("governor", RefGovernorConfig(merge_every=16))
    return RefRuntime(fleet, RefRuntimeConfig(
        topology=ref_ring(fs.n_devices, hops=2), ridge=RIDGE, detector=RefDetectorConfig(), **kw))


def _port(obs_scenario, **kw):
    fs, _, fleet = obs_scenario
    kw.setdefault("governor", GovernorConfig(merge_every=16))
    states = oselm_state_from_numpy(fleet.params.alpha, fleet.params.bias, fleet.beta, fleet.p,
                                    activation=fleet.activation, forget=fleet.forget,
                                    device="cpu")
    return FleetRuntime(states, RuntimeConfig(
        topology=ring(fs.n_devices, hops=2), ridge=RIDGE, detector=DetectorConfig(), **kw),
        device="cpu")


@pytest.fixture(scope="module")
def soaks(obs_scenario):
    """(reference summary, port summary, port reports with telemetry on,
    port reports with telemetry off) over the fixture's 60 ticks."""
    fs, batch, _ = obs_scenario
    ref = _reference(obs_scenario, telemetry=RefTelemetryConfig(band_sample_every=1))
    ref.run(RefTickFeed(fs, batch))
    on = _port(obs_scenario, telemetry=TelemetryConfig(band_sample_every=1))
    reports_on = on.run(TickFeed(fs, batch))
    off = _port(obs_scenario)
    reports_off = off.run(TickFeed(fs, batch))
    assert off.telemetry is None and off.finalize_telemetry() is None
    return ref.finalize_telemetry(), on.finalize_telemetry(), reports_on, reports_off, on


def _same_keys(got, want, where="summary"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            f"{where}: {sorted(set(got) ^ set(want))}")
        for k in want:
            _same_keys(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list) and want and isinstance(want[0], dict):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_keys(g, w, f"{where}[{i}]")


def test_summary_has_the_reference_keys_at_every_level(soaks):
    want, got = soaks[0], soaks[1]
    _same_keys(got, want)
    assert list(got["metrics"]) == list(want["metrics"])  # the catalog, in declaration order


def test_summary_counts_equal_the_reference(soaks):
    want, got, _, _, port = soaks
    for key in ("ticks", "merge_rounds", "bytes_by_precision", "bytes_total",
                "detections_total", "nonfinite_payloads_total", "slo_breaches_total",
                "fault_events"):
        assert got[key] == want[key], key
    assert got["ticks"] == 60 and got["merge_rounds"] >= 1 and got["detections_total"] > 0
    assert got["merge_rounds"] == port.governor.state.merges
    assert got["bytes_total"] == port.governor.state.bytes_spent
    assert got["detections_total"] == port.detections_total
    assert got["flight"]["recorded"] == want["flight"]["recorded"] == 60
    # the band histograms, sampled every tick here, saw the same devices
    for name in ("detector_band_width", "detector_loss_ratio"):
        assert (got["metrics"][name]["series"][0]["count"]
                == want["metrics"][name]["series"][0]["count"] > 0)
    # each tick's phases were timed: the same phases, the same counts
    assert {p: s["count"] for p, s in got["phases"].items()} == {
        p: s["count"] for p, s in want["phases"].items()}
    assert {"poison", "ingest", "quantize", "govern", "merge"} <= set(got["phases"])


def test_summary_timings_are_positive_seconds(soaks):
    got = soaks[1]
    lat = got["tick_latency"]
    assert lat["count"] == 60
    for k in ("mean_s", "p50_s", "p99_s", "max_s"):
        assert isinstance(lat[k], float) and lat[k] > 0
    for stats in got["phases"].values():
        assert all(isinstance(stats[k], float) and stats[k] >= 0
                   for k in ("mean_s", "p50_s", "p99_s", "max_s"))


def test_reports_are_the_same_with_telemetry_on_and_off(soaks):
    _, _, on, off, _ = soaks
    assert len(on) == len(off) == 60
    for a, b in zip(on, off):
        assert np.array_equal(a.losses, b.losses)
        assert np.array_equal(a.drifted, b.drifted)
        assert np.array_equal(a.fresh_detections, b.fresh_detections)
        assert dataclasses.asdict(a.decision) == dataclasses.asdict(b.decision)


def test_flight_ring_records_the_ticks_as_the_reference_does(soaks):
    _, _, reports, _, port = soaks
    ring_ = port.telemetry.flight.records()
    assert [r["tick"] for r in ring_] == list(range(60 - len(ring_), 60))
    last = ring_[-1]
    assert last["losses"] == pytest.approx(np.asarray(reports[-1].losses, np.float64), rel=1e-6)
    assert last["decision"]["merge"] == reports[-1].decision.merge


NAN_FAULT = dict(kind="nan", frac=0.2, start_tick=4, seed=3)


def test_runtime_flight_dump_on_nan_payload(tmp_path, obs_scenario):
    """A NaN payload dumps ``flight_<tick>.json`` whose inputs are the
    failing tick's post-poison batch and whose ring ends at that tick; the
    non-finite count equals the reference's on the same schedule."""
    fs, batch, _ = obs_scenario
    port = _port(obs_scenario, telemetry=TelemetryConfig(dir=str(tmp_path / "tel")),
                 governor=GovernorConfig(merge_every=8), robust=RobustConfig(trim=1),
                 faults=FaultInjector((FaultSpec(**NAN_FAULT),), fs.n_devices, seed=0))
    feed = TickFeed(fs, batch)
    reports = port.run(feed)
    summary = port.finalize_telemetry()
    assert summary["nonfinite_payloads_total"] > 0
    assert summary["flight"]["dumps"], "no flight dump written"
    dump = load_dump(summary["flight"]["dumps"][0])
    assert dump["reason"] == "nonfinite"
    t = dump["tick"]
    assert reports[t].nonfinite_payloads > 0
    np.testing.assert_array_equal(dump["inputs"], feed.tick_batch(t))
    assert dump["ring"][-1]["tick"] == t
    assert dump["ring"][-1]["losses"] == pytest.approx(
        np.asarray(reports[t].losses, np.float64), rel=1e-6)

    ref = _reference(obs_scenario, telemetry=RefTelemetryConfig(),
                     governor=RefGovernorConfig(merge_every=8), robust=RefRobustConfig(trim=1),
                     faults=RefFaultInjector((RefFaultSpec(**NAN_FAULT),), fs.n_devices, seed=0))
    ref.run(RefTickFeed(fs, batch))
    want = ref.finalize_telemetry()
    for key in ("nonfinite_payloads_total", "fault_events", "merge_rounds", "bytes_total"):
        assert summary[key] == want[key], key


def test_exception_in_a_tick_dumps_the_ring_with_its_inputs(tmp_path, obs_scenario, monkeypatch):
    fs, batch, _ = obs_scenario
    port = _port(obs_scenario, telemetry=TelemetryConfig(dir=str(tmp_path / "tel")))
    feed = TickFeed(fs, batch)
    for t in range(3):
        port.tick(feed.tick_batch(t))

    def boom(*a, **k):
        raise RuntimeError("ingest failed")

    monkeypatch.setattr(port, "_ingest_detect", boom)
    with pytest.raises(RuntimeError, match="ingest failed"):
        port.tick(feed.tick_batch(3))
    (path,) = port.telemetry.flight.dumps
    dump = load_dump(path)
    assert dump["reason"] == "exception" and dump["tick"] == 3
    np.testing.assert_array_equal(dump["inputs"], feed.tick_batch(3))
    assert [r["tick"] for r in dump["ring"]] == [0, 1, 2]
    assert (tmp_path / "tel" / "exposition.txt").exists()


def test_warmup_leaves_telemetry_untouched(obs_scenario):
    fs, batch, _ = obs_scenario
    port = _port(obs_scenario, telemetry=TelemetryConfig())
    before = port.telemetry.state()
    port.warmup(batch)
    assert port.telemetry.state() == before and port.tick_no == 0


def test_serve_telemetry_dir_writes_trace_and_exposition(tmp_path, capsys):
    from repro_torch.launch.serve import main

    out = tmp_path / "tel"
    rounds = main(["--arch", "hymba-1.5b", "--rounds", "2", "--batch", "2", "--prompt-len", "16",
                   "--new-tokens", "2", "--device", "cpu", "--telemetry-dir", str(out)])
    assert len(rounds) == 2
    events = [json.loads(x) for x in (out / "trace.jsonl").read_text().splitlines()]
    assert [(e["name"], e["round"]) for e in events] == [("serve_round", 0), ("serve_round", 1)]
    text = (out / "exposition.txt").read_text()
    assert "serve_rounds_total 2" in text and "serve_tokens_total 8" in text
    assert "# TYPE serve_round_seconds histogram" in text
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("telemetry:")]
    summary = json.loads(line[0].split(":", 1)[1])
    assert summary["rounds"] == 2 and summary["tokens"] == 8
    assert summary["drift_flags"] == sum(r.flagged for r in rounds)
