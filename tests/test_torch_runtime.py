"""The port's ``FleetRuntime`` against the reference's, tick by tick, on
the CPU.

Both runtimes take the same scenario ticks (``make_scenario("har", ...)``
at odd sizes, as ``tests/test_differential.py`` builds them) from the same
initial fleet, handed over as numpy through ``repro_torch.convert``. The
reference runs its kernel family (Pallas ingest and merge kernels in
interpret mode); the port runs its kernels' plain versions. Bounds:

- losses at rtol 2e-4 / atol 1e-6 on every tick, and at rtol 1e-5 /
  atol 1e-6 on every tick up to the first merge (its own tick included,
  as its loss is scored before the merge). After a merge the bound
  cannot be 1e-5: the reference's own two ingest forms (XLA and Pallas)
  already differ by up to 1.4e-4 relative after two merges on this
  fixture, because the f32 matrix products sum in different orders and
  the RLS chain amplifies that by κ(P). So each run also holds the port's
  largest deviation from the reference to at most twice the largest
  deviation of the reference's XLA ingest from its Pallas ingest on the
  same ticks (measured: at most 1.1 times);
- ``drifted``, ``fresh_detections`` and the merge decision exactly;
- the final state at rtol 1e-4 / atol 1e-5, the reference's own bound
  for a multi-tick accumulation of its kernel ingest.

The int8 runtime (``payload_precision="int8"``) is held the same way, with
one more source of spread: across frameworks U and V differ by ~1e-7, so
a code can flip at a .5 boundary, and one flipped code moves a payload
value by a whole quantization step. Flags, decisions and fp-participants
are equal on every tick, losses at 1e-5 up to the first merge, and after
it the port's largest loss deviation is at most twice the reference's own
spread between its XLA path (XLA ingest, ``use_merge_kernel=False``) and
its kernel path on the same ticks. Each round's flipped codes are counted from the
residuals (a flip moves the residual by about one step).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.fleet import ring as ref_ring, star as ref_star
from repro.runtime import (
    FleetRuntime as RefRuntime,
    GovernorConfig as RefGovernorConfig,
    RuntimeConfig as RefRuntimeConfig,
)
from repro.scenarios import make_scenario
from repro_torch.convert import oselm_state_from_numpy
from repro_torch.fleet import ring, star
from repro_torch.runtime import DetectorConfig, FleetRuntime, GovernorConfig, RuntimeConfig

torch.set_num_threads(2)

SPEC_ODD = dict(n_devices=5, ticks=10, batch=3, n_hidden=10)
TOPOS = {"star": (star, ref_star), "ring": (lambda d: ring(d, 1), lambda d: ref_ring(d, 1))}
# the scenario's detector (warmup 20) never leaves calibration in 10 ticks;
# the short one does, so flags and post-merge rebases are exercised too
SHORT_DETECTOR = dict(warmup=3, warmup_skip=1, rel_sigma=0.05, k_sigma=1.0, patience=2)
# the int8 runtime runs 40 ticks (10 rounds): with two rounds the spread
# of either run rests on a handful of flipped codes, and by tick 40 the
# scenario detector has flagged a device and priced one at f32
INT8_TICKS = 40


def _pair(topo_name, forget, detector, *, twin=False, precision="f32", ticks=None):
    """(scenario, reference runtime on Pallas kernels, port runtime) and,
    with ``twin``, a fourth: the reference runtime on its XLA ingest, and
    for a lossy precision on its XLA merge too."""
    over = dict(SPEC_ODD)
    if ticks is not None:
        over["ticks"] = ticks
    if forget != 1.0:
        over["forget"] = forget
    if detector == "short":
        base = make_scenario("har", **over).detector
        over["detector"] = dataclasses.replace(base, **SHORT_DETECTOR)
    sc = make_scenario("har", **over).build()
    fleet = sc.init_fleet(jax.random.PRNGKey(0))
    port_topo, ref_topo = TOPOS[topo_name]
    d = sc.spec.n_devices

    def reference(ingest_backend, merge_kernel=True):
        return RefRuntime(fleet, RefRuntimeConfig(
            topology=ref_topo(d), ridge=sc.spec.ridge, detector=sc.spec.detector,
            governor=RefGovernorConfig(merge_every=4), use_ingest_kernel=True,
            ingest_backend=ingest_backend, use_merge_kernel=merge_kernel,
            payload_precision=precision,
        ))

    ref = reference("pallas")
    port_fleet = oselm_state_from_numpy(
        fleet.params.alpha, fleet.params.bias, fleet.beta, fleet.p,
        activation=fleet.activation, forget=fleet.forget, device="cpu",
    )
    port = FleetRuntime(port_fleet, RuntimeConfig(
        topology=port_topo(d), ridge=sc.spec.ridge,
        detector=DetectorConfig(**dataclasses.asdict(sc.spec.detector)),
        governor=GovernorConfig(merge_every=4), payload_precision=precision,
    ), device="cpu")
    if twin:
        if precision == "f32":
            return sc, ref, port, reference("xla")
        return sc, ref, port, reference("xla", merge_kernel=False)
    return sc, ref, port


def _assert_same_report(got, want, *, losses=True):
    if losses:
        np.testing.assert_allclose(got.losses, want.losses, rtol=2e-4, atol=1e-6)
    assert np.array_equal(got.drifted, want.drifted)
    assert np.array_equal(got.fresh_detections, want.fresh_detections)
    assert got.decision.merge == want.decision.merge
    assert got.decision.reason == want.decision.reason
    assert got.decision.participants == want.decision.participants
    assert got.decision.round_bytes == want.decision.round_bytes
    assert got.decision.fp_participants == want.decision.fp_participants


def _max_rel(got, want):
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _assert_state_close(port, ref):
    np.testing.assert_allclose(port.states.p.numpy(), np.asarray(ref.states.p),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.states.beta.numpy(), np.asarray(ref.states.beta),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("detector", ["scenario", "short"])
@pytest.mark.parametrize("forget", [1.0, 0.97])
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_tick_reports_match_reference(topo_name, forget, detector):
    sc, ref, port, twin = _pair(topo_name, forget, detector, twin=True)
    port.warmup(sc.spec.batch)
    feed = sc.feed()
    merges = flags = 0
    port_dev, twin_dev = [], []
    for t in range(feed.n_ticks):
        batch = feed.tick_batch(t)
        want = ref.tick(batch)
        got = port.tick(batch)
        _assert_same_report(got, want)
        if not merges:  # up to and with the first merge's tick
            np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5, atol=1e-6)
        port_dev.append(_max_rel(got.losses, want.losses))
        twin_dev.append(_max_rel(twin.tick(batch).losses, want.losses))
        merges += want.decision.merge
        flags += int(want.fresh_detections.sum())
    assert merges > 0, "no merge admitted: the differential lost its teeth"
    if detector == "short":
        assert flags > 0, "no drift flag raised: the detector path went untested"
    assert max(port_dev) <= 2 * max(twin_dev), (
        f"the port strays further from the reference than the reference's own "
        f"XLA ingest does; per tick, port {port_dev}, XLA ingest {twin_dev}"
    )
    _assert_state_close(port, ref)


def _flipped_codes(got_r, want_r):
    """Codes that differ between two runs of one merge round, read off
    their residuals: a flip moves a residual by about one quantization
    step, twice the largest residual of its (device, 128-column) tile."""
    d, n, c = want_r.shape
    pad = -c % 128
    tiles = lambda r: np.pad(r, ((0, 0), (0, 0), (0, pad))).reshape(d, n, -1, 128)
    diff, ref = tiles(np.abs(got_r - want_r)), tiles(np.abs(want_r))
    step = 2 * ref.max(axis=(1, 3), keepdims=True)
    return int((diff > 0.5 * step).sum())


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_int8_tick_reports_match_reference(topo_name):
    sc, ref, port, twin = _pair(topo_name, 1.0, "scenario", twin=True, precision="int8",
                                ticks=INT8_TICKS)
    port.warmup(sc.spec.batch)
    feed = sc.feed()
    merges = fp_rounds = flags = 0
    port_dev, twin_dev, flips, twin_flips = [], [], [], []
    for t in range(feed.n_ticks):
        batch = feed.tick_batch(t)
        want = ref.tick(batch)
        got = port.tick(batch)
        _assert_same_report(got, want, losses=False)  # losses: the spread bound below
        if not merges:
            np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5, atol=1e-6)
        port_dev.append(_max_rel(got.losses, want.losses))
        twin_dev.append(_max_rel(twin.tick(batch).losses, want.losses))
        if want.decision.merge:
            merges += 1
            fp_rounds += want.decision.fp_participants > 0
            flips.append(_flipped_codes(port._residual.numpy(), np.asarray(ref._residual)))
            twin_flips.append(_flipped_codes(np.asarray(twin._residual), np.asarray(ref._residual)))
        flags += int(want.fresh_detections.sum())
    assert merges > 0, "no merge admitted: the differential lost its teeth"
    assert flags > 0, "no drift flag raised: the detector path went untested"
    assert fp_rounds > 0, "no f32 participant: the precision gate went untested"
    print(f"int8 {topo_name}: port {max(port_dev):.3e}, XLA path "
          f"{max(twin_dev):.3e}, flipped codes per round {flips}, XLA path {twin_flips}; "
          f"fp participants {fp_rounds}")
    assert max(port_dev) <= 2 * max(twin_dev), (
        f"the port strays further from the reference than the reference's own XLA "
        f"path does; per tick, port {port_dev}, XLA path {twin_dev}; flipped codes "
        f"per round {flips}"
    )


def test_selection_policies_match_reference():
    from repro.federated.selection import (
        fleet_loss_threshold as ref_threshold,
        fleet_resource_budget as ref_budget,
    )
    from repro_torch.federated.selection import fleet_loss_threshold, fleet_resource_budget

    rng = np.random.default_rng(3)
    losses = rng.uniform(0, 2, 50)
    losses[[4, 9]] = [np.nan, np.inf]
    cost = rng.uniform(0, 1, 50)
    assert np.array_equal(fleet_loss_threshold(1.0)(losses), ref_threshold(1.0)(losses))
    assert np.array_equal(fleet_resource_budget(cost, 0.5)(losses), ref_budget(cost, 0.5)(losses))


def test_policies_gate_participation_as_in_reference():
    """A selection policy ANDed into the governor's mask changes the
    participants of each round identically in both runtimes."""
    from repro.federated.selection import fleet_resource_budget as ref_budget
    from repro_torch.federated.selection import fleet_resource_budget

    sc, ref, port = _pair("star", 1.0, "scenario")
    cost = np.array([0.1, 0.9, 0.2, 0.3, 0.8])
    ref.governor.policies = (ref_budget(cost, 0.5),)
    port.governor.policies = (fleet_resource_budget(cost, 0.5),)
    feed = sc.feed()
    for t in range(feed.n_ticks):
        want, got = ref.tick(feed.tick_batch(t)), port.tick(feed.tick_batch(t))
        _assert_same_report(got, want)
        if got.decision.merge:
            assert got.decision.participants == 3
    _assert_state_close(port, ref)


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_served_and_allow_merge_match_reference(topo_name):
    """Partially served ticks keep unserved devices bit-frozen, and a
    vetoed candidate round is reported as "degraded" by both runtimes."""
    sc, ref, port = _pair(topo_name, 1.0, "short")
    feed = sc.feed()
    rng = np.random.default_rng(0)
    d = sc.spec.n_devices
    merges = 0
    for t in range(feed.n_ticks):
        batch = feed.tick_batch(t)
        served = rng.random(d) < 0.7 if t % 2 else None
        allow = t != 3
        before_p = port.states.p.clone()
        want = ref.tick(batch, served=served, allow_merge=allow)
        got = port.tick(batch, served=served, allow_merge=allow)
        _assert_same_report(got, want)
        merges += want.decision.merge
        if served is not None and not got.decision.merge:
            frozen = ~served
            assert torch.equal(port.states.p[frozen], before_p[frozen])
        if t == 3:
            assert got.decision.reason == "degraded"
    assert merges > 0
    _assert_state_close(port, ref)


@pytest.mark.parametrize("rebase", [False, True])
def test_detector_update_matches_reference(rebase):
    """One detector step from the same random bank: flags exact, state
    at f32 rounding (the arithmetic is the reference's, line by line)."""
    import jax.numpy as jnp

    from repro.runtime.detector import DetectorState as RefState, detector_update as ref_update
    from repro_torch.convert import detector_state_from_numpy
    from repro_torch.runtime import detector_update

    rng = np.random.default_rng(7)
    d = 41
    leaves = dict(
        ewma=rng.uniform(0.5, 2, d).astype(np.float32),
        mean=rng.uniform(0.5, 1.5, d).astype(np.float32),
        var=rng.uniform(0, 0.05, d).astype(np.float32),
        count=rng.integers(0, 12, d).astype(np.int32),
        drifted=rng.random(d) < 0.3,
        recovery=rng.integers(0, 4, d).astype(np.int32),
    )
    losses = rng.uniform(0.3, 3, d).astype(np.float32)
    part = rng.random(d) < 0.8
    cfg = dict(warmup=5, warmup_skip=1, rel_sigma=0.1, patience=3)
    from repro.runtime.detector import DetectorConfig as RefConfig

    want, w_drift, w_fresh = ref_update(
        RefState(**{k: jnp.asarray(v) for k, v in leaves.items()}), jnp.asarray(losses),
        RefConfig(**cfg), rebase=rebase, participants=jnp.asarray(part),
    )
    got, g_drift, g_fresh = detector_update(
        detector_state_from_numpy(**leaves, device="cpu"), torch.from_numpy(losses),
        DetectorConfig(**cfg), rebase=rebase, participants=torch.from_numpy(part),
    )
    assert np.array_equal(g_drift.numpy(), np.asarray(w_drift))
    assert np.array_equal(g_fresh.numpy(), np.asarray(w_fresh))
    for name in ("ewma", "mean", "var"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-7)
    for name in ("count", "recovery"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
