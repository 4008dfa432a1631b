"""Snapshots of the port's ``FleetRuntime`` against the reference's, on
the CPU, on fresh f32, int8, hardened (robust merge and faults) and stale
runtimes.

Both runtimes are built as ``tests/test_torch_runtime.py`` builds them
(``_pair``; the stale ones as ``tests/test_torch_staleness.py`` builds
them) and tick side by side for 40 ticks; then each snapshots.

(a) The port's file holds the reference's manifest letter for letter,
    with the same shapes and dtypes: the shared basis broadcast to
    (D, n, Ñ), the stale ring split into ``hist_u`` and ``hist_v``.
(b) A fresh port runtime restores the reference's snapshot and ticks on
    beside the reference; (c) a fresh reference runtime restores the
    port's snapshot and ticks on beside the port. Flags, decisions,
    non-finite counts and the robust quarantine are equal; losses are
    held at ``test_torch_runtime.py``'s bounds: 1e-5 up to the first
    merge after the restore, then 2e-4 (f32 and stale), 5e-2 (int8:
    twice the reference's own ten-round spread between its XLA and kernel
    paths there) or 5e-4 (hardened, the robust arm's floor).
(d) The port's own kill/restore (snapshots every 8, killed at 20,
    restored at 16, replayed) is tick-identical to an uninterrupted port
    run, bit for bit on the CPU, with telemetry counters continuous.
(e) A snapshot whose devices carry different bases raises ValueError
    from ``restore``, after the load.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from test_torch_runtime import HARD_FAULTS, HARD_LOSS_RTOL, _assert_same_report, _pair
from test_torch_staleness import RT_TOPOS, SHORT_DETECTOR, _port_runtime

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.fleet import StalenessSchedule as RefSchedule
from repro.runtime import (
    FleetRuntime as RefRuntime,
    GovernorConfig as RefGovernorConfig,
    RuntimeConfig as RefRuntimeConfig,
)
from repro.scenarios import make_scenario
from repro_torch.checkpoint import CheckpointManager
from repro_torch.obs import TelemetryConfig
from repro_torch.runtime import FleetRuntime

torch.set_num_threads(2)

KINDS = ("fresh", "int8", "hardened", "stale")
# losses after the first merge that follows the restore, relative: the exact
# merges at test_torch_runtime.py's 2e-4 (ROADMAP queue 3); int8 at twice
# the reference's own spread between its XLA and kernel paths over ten
# rounds (test_torch_runtime.py measured up to 2.5e-2; chip_smoke.py's
# INT8_LOSS_RTOL); hardened at the robust arm's 5e-4 floor
LOSS_RTOL = {"fresh": 2e-4, "int8": 5e-2, "hardened": HARD_LOSS_RTOL, "stale": 2e-4}
SNAP_TICK, AFTER = 40, 8
SPEC = dict(n_devices=5, ticks=SNAP_TICK + AFTER, batch=3, n_hidden=10)
HARD_SPEC = dict(n_devices=6, ticks=SNAP_TICK + AFTER, batch=3, n_hidden=10)


def _runtimes(kind):
    """(feed, reference, port, a maker of a fresh runtime of either
    package: ``make("ref" | "port")``)."""
    if kind == "stale":
        # test_torch_staleness.py's runtime, on a feed long enough for tick 40
        port_fn, ref_fn = RT_TOPOS["star"]
        base = make_scenario("har", **SPEC).detector
        sc = make_scenario("har", **SPEC,
                           detector=dataclasses.replace(base, **SHORT_DETECTOR)).build()
        fleet = sc.init_fleet(jax.random.PRNGKey(0))
        d = sc.spec.n_devices
        lags = RefSchedule.random(d, max_lag=2, seed=1).lags

        def make(which):
            if which == "port":
                return _port_runtime(sc, fleet, port_fn(d), lags)
            return RefRuntime(fleet, RefRuntimeConfig(
                topology=ref_fn(d), ridge=sc.spec.ridge, detector=sc.spec.detector,
                governor=RefGovernorConfig(merge_every=4), use_ingest_kernel=True,
                ingest_backend="pallas", staleness=RefSchedule(lags),
            ))
        return sc.feed(), make("ref"), make("port"), make
    kw = dict(fresh=dict(detector="short", spec=SPEC),
              int8=dict(detector="scenario", spec=SPEC, precision="int8"),
              hardened=dict(detector="scenario", spec=HARD_SPEC,
                            hardened=(HARD_FAULTS, 1)))[kind]

    def make(which):
        _, ref, port = _pair("star", 1.0, **kw)
        return {"ref": ref, "port": port}[which]

    sc, ref, port = _pair("star", 1.0, **kw)
    return sc.feed(), ref, port, make


def _manifest(path):
    with np.load(path) as z:
        keys = json.loads(str(z["__keys__"]))
        return [(k, z[f"leaf_{i}"].dtype.str, z[f"leaf_{i}"].shape) for i, k in enumerate(keys)]


def _rel(got, want):
    live = np.isfinite(want)
    if not live.any():
        return 0.0
    return float(np.max(np.abs(got[live] - want[live]) / np.abs(want[live])))


def _hold(kind, got, want, merged):
    """One tick's reports at the bounds test_torch_runtime.py holds."""
    _assert_same_report(got, want, losses=False)
    np.testing.assert_array_equal(np.isfinite(got.losses), np.isfinite(want.losses))
    if not merged:
        np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5, atol=1e-6)
    live = np.isfinite(want.losses)
    np.testing.assert_allclose(got.losses[live], want.losses[live], rtol=LOSS_RTOL[kind],
                               atol=1e-6)
    assert got.nonfinite_payloads == want.nonfinite_payloads
    if want.decision.merge and want.robust_scores is not None:
        np.testing.assert_allclose(got.robust_scores, want.robust_scores, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kind", KINDS)
def test_snapshots_cross_between_the_packages(kind, tmp_path):
    feed, ref, port, _ = _runtimes(kind)
    ref.ckpt = RefCheckpointManager(tmp_path / "ref")
    port.ckpt = CheckpointManager(tmp_path / "port")
    for t in range(SNAP_TICK):
        want, got = ref.tick(feed.tick_batch(t)), port.tick(feed.tick_batch(t))
        _assert_same_report(got, want, losses=False)
    ref_file, port_file = ref.snapshot(), port.snapshot()
    at_snap = {"ref": (np.array(ref.states.beta), list(ref.detections)),
               "port": (port.states.beta.numpy().copy(), list(port.detections))}

    # (a) the same manifest, shapes and dtypes
    assert _manifest(port_file) == _manifest(ref_file)

    def tail(rt):
        reports = [rt.tick(feed.tick_batch(t)) for t in range(SNAP_TICK, feed.n_ticks)]
        return reports, rt.governor.robust_quarantined.copy(), rt.merge_round

    # each package ticks on from its own state, then restores the other's
    # file (which rewinds it to tick 40) and ticks the same tail again
    ref_own, port_own = tail(ref), tail(port)
    ref.ckpt, port.ckpt = RefCheckpointManager(tmp_path / "port"), CheckpointManager(
        tmp_path / "ref")
    assert ref.restore() == port.restore() == SNAP_TICK
    for rt, source in ((port, "ref"), (ref, "port")):
        np.testing.assert_array_equal(np.asarray(rt.states.beta), at_snap[source][0])
        assert list(rt.detections) == at_snap[source][1]
    ref_from_port, port_from_ref = tail(ref), tail(port)

    devs = {}
    # (b) the port from the reference's file against the reference, (c) the
    # reference from the port's file against the port
    cases = {"b": (port_from_ref, ref_own), "c": (ref_from_port, port_own)}
    for case, (got, want) in cases.items():
        merged, devs[case] = False, []
        for a, b in zip(got[0], want[0], strict=True):
            _hold(kind, a, b, merged)
            devs[case].append(_rel(a.losses, b.losses))
            merged |= b.decision.merge
        assert merged, "no merge after the restore: the differential lost its teeth"
        np.testing.assert_array_equal(got[1], want[1])  # the robust quarantine
        assert got[2] == want[2]                         # merge rounds
    print(f"{kind}: losses after the restore, port from the reference's file"
          f" {max(devs['b']):.3e}, reference from the port's {max(devs['c']):.3e}"
          f" (bound {LOSS_RTOL[kind]:.0e})")
    assert max(devs["b"] + devs["c"]) <= LOSS_RTOL[kind], devs
    if kind == "hardened":
        assert port_from_ref[1].any(), "no device quarantined"


KILL_TICK, EVERY = 20, 8


@pytest.mark.parametrize("kind", KINDS)
def test_kill_restore_is_tick_identical(kind, tmp_path):
    """The port killed between snapshots, restored from the newest and
    replayed: every report and the final state equal an uninterrupted
    run's, and (with telemetry on) the counters carry on where they were."""
    feed, _, _, make = _runtimes(kind)

    def runtime(snapshots):
        rt = make("port")
        config = dataclasses.replace(
            rt.config, telemetry=TelemetryConfig(), snapshot_every=EVERY if snapshots else None,
            snapshot_dir=tmp_path if snapshots else None, snapshot_keep=2)
        return FleetRuntime(rt.states, config, device="cpu")

    whole = runtime(False)
    want = [whole.tick(feed.tick_batch(t)) for t in range(feed.n_ticks)]
    doomed = runtime(True)
    for t in range(KILL_TICK):
        doomed.tick(feed.tick_batch(t))
    del doomed
    revived = runtime(True)
    t0 = revived.restore()
    assert t0 == KILL_TICK // EVERY * EVERY
    assert int(revived.telemetry.ticks.value) == t0
    got = [revived.tick(feed.tick_batch(t)) for t in range(t0, feed.n_ticks)]
    for a, b in zip(got, want[t0:], strict=True):
        np.testing.assert_array_equal(a.losses, b.losses)
        np.testing.assert_array_equal(a.drifted, b.drifted)
        np.testing.assert_array_equal(a.fresh_detections, b.fresh_detections)
        assert a.decision == b.decision
        assert a.nonfinite_payloads == b.nonfinite_payloads
        if b.robust_scores is None:
            assert a.robust_scores is None
        else:
            np.testing.assert_array_equal(a.robust_scores, b.robust_scores)
    assert sum(r.decision.merge for r in want[t0:]) >= 2
    assert torch.equal(revived.states.beta, whole.states.beta)
    assert torch.equal(revived.states.p, whole.states.p)
    assert revived.detections_total == whole.detections_total
    a, b = revived.finalize_telemetry(), whole.finalize_telemetry()
    for key in ("ticks", "merge_rounds", "bytes_total", "detections_total",
                "nonfinite_payloads_total"):
        assert a[key] == b[key], key


def test_per_device_bases_raise_from_restore(tmp_path):
    """A reference snapshot of a fleet whose devices carry different bases
    is read, then refused with ValueError (not stepped past as unreadable)."""
    feed, ref, port, _ = _runtimes("fresh")
    st = ref.states
    alpha = np.array(st.params.alpha)
    alpha[1] += 1.0
    ref.states = st.replace(params=st.params._replace(alpha=jax.numpy.asarray(alpha)))
    ref.ckpt = RefCheckpointManager(tmp_path)
    ref.snapshot()
    port.ckpt = CheckpointManager(tmp_path)
    with pytest.raises(ValueError, match="per-device SLFN bases"):
        port.restore()
    with pytest.raises(RuntimeError, match="no snapshot_dir"):
        _runtimes("fresh")[2].snapshot()
