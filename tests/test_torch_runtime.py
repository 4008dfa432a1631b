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

The hardened runtime (``robust=``, ``faults=``) is held on star and ring,
with a ×−25 scale attacker, a NaN device, a crash window and a poisoned
window, on the robust arm (trim = 1) and on the naive arm: flags,
decisions, non-finite payload counts and the robust quarantine equal
after every round; scores at 1e-3; losses at 1e-5 up to the first merge.
After it the port's largest loss deviation is held at the larger of 5e-4
and twice the reference's own spread between its kernel path and its
XLA path (XLA ingest, oracle merge) on the same ticks. 5e-4 is not the
exact merge's 2e-4: the trimmed arm solves by Cholesky and ``eigh`` in
both packages, so it does not see payloads that agree to the bit (the two
packages' Cholesky inverses of P, U = P⁻¹, differ by 1.8e-5 relative on
this fixture), and the trimmed mean and κ(U) = 287 carry that to 1.2e-4
on β in one round, against 5.4e-6 from the reference's own payload
(``test_robust_merge_spread_follows_the_payloads`` prints these); the
port's loss deviation then reached 2.3e-4 on star
(measured, against 8.5e-5 for the reference's twin, whose merges see
identical arithmetic). On the ring the twin's own spread is larger (up
to 9.5e-2: ±1-hop neighbourhoods of three trimmed to their median and
PSD-repaired are ill conditioned) and sets the bound. The naive arm's
merges are poisoned by the NaN device, as in the reference: its losses
are NaN in the same places in both.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.fleet import FaultInjector as RefFaultInjector
from repro.fleet import FaultSpec as RefFaultSpec
from repro.fleet import RobustConfig as RefRobustConfig
from repro.fleet import ring as ref_ring, star as ref_star
from repro.runtime import (
    FleetRuntime as RefRuntime,
    GovernorConfig as RefGovernorConfig,
    RuntimeConfig as RefRuntimeConfig,
)
from repro.scenarios import make_scenario
from repro_torch.convert import oselm_state_from_numpy
from repro_torch.fleet import FaultInjector, FaultSpec, RobustConfig, ring, star
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
# the detection ring's run: enough ticks for the short detector to raise
# more fresh detections (8) than the ring's cap (5)
RING_TICKS = 40


def _pair(topo_name, forget, detector, *, twin=False, precision="f32", ticks=None,
          spec=None, hardened=None, detections_cap=4096):
    """(scenario, reference runtime on Pallas kernels, port runtime) and,
    with ``twin``, a fourth: the reference runtime on its XLA ingest, and
    for a lossy precision or a hardened runtime on its XLA merge too.
    ``hardened`` is (fault spec dicts, trim or None for the naive arm)."""
    over = dict(SPEC_ODD if spec is None else spec)
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
    faults, trim = hardened if hardened is not None else ((), None)
    hard = {}
    if hardened is not None:
        hard = dict(faults=RefFaultInjector(tuple(RefFaultSpec(**f) for f in faults), d),
                    robust=None if trim is None else RefRobustConfig(trim=trim))

    def reference(ingest_backend, merge_kernel=True):
        return RefRuntime(fleet, RefRuntimeConfig(
            topology=ref_topo(d), ridge=sc.spec.ridge, detector=sc.spec.detector,
            governor=RefGovernorConfig(merge_every=4), use_ingest_kernel=True,
            ingest_backend=ingest_backend, use_merge_kernel=merge_kernel,
            payload_precision=precision, detections_cap=detections_cap, **hard,
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
        detections_cap=detections_cap,
        **({} if hardened is None else dict(
            faults=FaultInjector(tuple(FaultSpec(**f) for f in faults), d),
            robust=None if trim is None else RobustConfig(trim=trim))),
    ), device="cpu")
    if twin:
        if precision == "f32" and hardened is None:
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


# a wide hidden layer (Ñ = 256, n = 561 features of the har scenario) for a
# few ticks, two merges: what the card's merges and ingest take since they
# hold Ñ up to 320; held as the narrow runtime is held. The scenario's har
# windows have rank ~120, so at the spec's ridge 1e-3 the Eq. 13 boot of
# either package is not finite past Ñ ≈ 100; ridge 1 keeps it well posed
WIDE_SPEC = dict(n_devices=5, ticks=8, batch=3, n_hidden=256, ridge=1.0)


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_wide_layer_tick_reports_match_reference(topo_name):
    sc, ref, port, twin = _pair(topo_name, 1.0, "short", twin=True, spec=WIDE_SPEC)
    assert port.states.p.shape[1] == 256
    port.warmup(sc.spec.batch)
    feed = sc.feed()
    merges = 0
    port_dev, twin_dev = [], []
    for t in range(feed.n_ticks):
        batch = feed.tick_batch(t)
        want = ref.tick(batch)
        got = port.tick(batch)
        _assert_same_report(got, want)
        if not merges:
            np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5, atol=1e-6)
        port_dev.append(_max_rel(got.losses, want.losses))
        twin_dev.append(_max_rel(twin.tick(batch).losses, want.losses))
        merges += want.decision.merge
    assert merges == 2
    assert max(port_dev) <= 2 * max(twin_dev), (port_dev, twin_dev)
    _assert_state_close(port, ref)


# past the card's cluster solve and P chain (Ñ > 320: the blocked wide
# solve, P in global memory), three devices, the reports held as the
# Ñ = 256 runtime's; the final state at twice the reference's own spread
# between its Pallas and XLA ingests (measured: 2.2e-4 on β against the
# port's 2.1e-5), since at this width one ulp of a merge moves β past the
# narrow runtime's 1e-5
WIDER_SPEC = dict(WIDE_SPEC, n_devices=3, n_hidden=384)


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_wider_layer_tick_reports_match_reference(topo_name):
    sc, ref, port, twin = _pair(topo_name, 1.0, "short", twin=True, spec=WIDER_SPEC)
    assert port.states.p.shape[1] == 384
    feed = sc.feed()
    merges = 0
    port_dev, twin_dev = [], []
    for t in range(feed.n_ticks):
        batch = feed.tick_batch(t)
        want = ref.tick(batch)
        got = port.tick(batch)
        _assert_same_report(got, want)
        if not merges:
            np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5, atol=1e-6)
        port_dev.append(_max_rel(got.losses, want.losses))
        twin_dev.append(_max_rel(twin.tick(batch).losses, want.losses))
        merges += want.decision.merge
    assert merges == 2
    assert max(port_dev) <= 2 * max(twin_dev), (port_dev, twin_dev)
    for name in ("p", "beta"):
        want = np.asarray(getattr(ref.states, name))
        port_err = float(np.abs(getattr(port.states, name).numpy() - want).max())
        twin_err = float(np.abs(np.asarray(getattr(twin.states, name)) - want).max())
        print(f"Ñ=384 {topo_name} {name}: port {port_err:.3e}, reference XLA ingest {twin_err:.3e}")
        assert port_err <= 2 * twin_err, (name, port_err, twin_err)


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


HARD_SPEC = dict(n_devices=6, ticks=24, batch=3, n_hidden=10)
HARD_FAULTS = (
    dict(kind="scale", devices=(1,), magnitude=-25.0, start_tick=4),
    dict(kind="nan", devices=(4,), start_tick=7, period=8),       # rounds at 7, 15, 23
    dict(kind="crash", devices=(2,), start_tick=6, end_tick=14),
    dict(kind="poison", devices=(3,), start_tick=10, end_tick=12, magnitude=2.0, seed=5),
)
HARD_LOSS_RTOL = 5e-4


def _finite_max_rel(got, want):
    live = np.isfinite(want)
    return _max_rel(got[live], want[live]) if live.any() else 0.0


@pytest.mark.parametrize("arm", ["robust", "naive"])
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_hardened_tick_reports_match_reference(topo_name, arm):
    trim = 1 if arm == "robust" else None
    sc, ref, port, twin = _pair(topo_name, 1.0, "scenario", twin=True, spec=HARD_SPEC,
                                hardened=(HARD_FAULTS, trim))
    port.warmup(sc.spec.batch)
    feed = sc.feed()
    merges = nonfinite = 0
    port_dev, twin_dev, score_dev = [], [], []
    for t in range(feed.n_ticks):
        batch = feed.tick_batch(t)
        want, got = ref.tick(batch), port.tick(batch)
        _assert_same_report(got, want, losses=False)
        np.testing.assert_array_equal(np.isfinite(got.losses), np.isfinite(want.losses))
        if not merges:
            np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5, atol=1e-6)
        port_dev.append(_finite_max_rel(got.losses, want.losses))
        twin_dev.append(_finite_max_rel(twin.tick(batch).losses, want.losses))
        assert got.nonfinite_payloads == want.nonfinite_payloads
        np.testing.assert_array_equal(port.governor.robust_quarantined,
                                      ref.governor.robust_quarantined)
        if want.decision.merge:
            merges += 1
            nonfinite += want.nonfinite_payloads
            np.testing.assert_allclose(got.robust_scores, want.robust_scores, rtol=1e-3,
                                       atol=1e-3)
            score_dev.append(_max_rel(got.robust_scores + 1.0, want.robust_scores + 1.0))
        else:
            assert got.robust_scores is None and want.robust_scores is None
    assert merges >= 5 and nonfinite > 0, "the fault schedule went untested"
    if trim is not None:
        assert port.governor.robust_quarantined[1], "the attacker was never quarantined"
        assert np.isfinite(port.states.beta.numpy()).all()
    else:
        assert not np.isfinite(want.losses).any(), "the naive arm was not poisoned"
    print(f"hardened {topo_name} {arm}: losses port {max(port_dev):.3e}, XLA path "
          f"{max(twin_dev):.3e}; scores {max(score_dev):.3e}")
    assert max(port_dev) <= max(HARD_LOSS_RTOL, 2 * max(twin_dev)), (
        f"per tick, port {port_dev}, XLA path {twin_dev}")


def test_robust_merge_spread_follows_the_payloads():
    """Where the hardened runtime's wider loss spread comes from: the
    trimmed merge of the reference's states at the first round, fed the
    reference's payload, agrees closely with the reference's merge; fed
    the port's own payload (the port's Cholesky inverse of P), it strays
    further, as the trimmed mean and κ(U) carry the payloads' last-bit
    difference. Prints the numbers the module docstring quotes."""
    import jax.numpy as jnp

    from repro.fleet import fleet_to_uv as ref_fleet_to_uv
    from repro.fleet.robust import robust_merge_from_w as ref_robust_merge_from_w
    from repro_torch.fleet import robust_merge_from_w
    from repro_torch.fleet.fleet import _packed_uv

    sc, ref, _ = _pair("star", 1.0, "scenario", spec=HARD_SPEC,
                       hardened=(HARD_FAULTS, 1))
    feed = sc.feed()
    for t in range(3):  # the first round is at tick 3
        ref.tick(feed.tick_batch(t))
    st, d, ridge = ref.states, sc.spec.n_devices, sc.spec.ridge
    uv = ref_fleet_to_uv(st, ridge=ridge)
    w_ref = np.array(jnp.concatenate([uv.u, uv.v], axis=2))
    want, _ = ref_robust_merge_from_w(st, ref_star(d), jnp.ones(d), jnp.asarray(w_ref),
                                      RefRobustConfig(trim=1), ridge, kernel=True)
    port_st = oselm_state_from_numpy(st.params.alpha, st.params.bias, st.beta, st.p,
                                     activation=st.activation, forget=st.forget, device="cpu")
    w_own = _packed_uv(port_st, ridge)[1]
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    devs = {}
    for name, w in (("own", w_own), ("reference's", torch.from_numpy(w_ref))):
        got, _ = robust_merge_from_w(port_st, star(d), torch.ones(d), w, RobustConfig(trim=1),
                                     ridge)
        devs[name] = rel(got.beta.numpy(), np.asarray(want.beta))
    payload = rel(w_own.numpy(), w_ref)
    cond = float(np.linalg.cond(w_ref[0, :, : w_ref.shape[1]]))
    print(f"payloads differ by {payload:.2e}; merged β from the port's own payload "
          f"{devs['own']:.2e}, from the reference's {devs["reference's"]:.2e}; "
          f"cond(U) {cond:.0f}")
    assert devs["reference's"] < 2e-5 < devs["own"]


def test_hardened_runtime_validation():
    sc = make_scenario("har", **SPEC_ODD).build()
    fleet = sc.init_fleet(jax.random.PRNGKey(0))
    port_fleet = oselm_state_from_numpy(fleet.params.alpha, fleet.params.bias, fleet.beta,
                                        fleet.p, activation=fleet.activation,
                                        forget=fleet.forget, device="cpu")
    with pytest.raises(ValueError, match="payload_precision='f32'"):
        FleetRuntime(port_fleet, RuntimeConfig(topology=star(5), robust=RobustConfig(),
                                               payload_precision="int8"), device="cpu")
    with pytest.raises(ValueError, match="fault injector is for 4 devices"):
        FleetRuntime(port_fleet, RuntimeConfig(
            topology=star(5), faults=FaultInjector((FaultSpec(kind="nan", devices=(1,)),), 4),
        ), device="cpu")


def test_tick_checks_the_batch_before_poisoning_it():
    """A batch of the wrong shape is refused before a poison fault touches
    it: D = 6 with device 5 poisoned, and a (4, 8, n) batch. Both runtimes
    raise the shape error (poisoning first would index device 5 of 4)."""
    poison = dict(kind="poison", devices=(5,), start_tick=0, magnitude=2.0, seed=0)
    sc, ref, port = _pair("star", 1.0, "scenario", spec=dict(SPEC_ODD, n_devices=6),
                          hardened=([poison], None))
    batch = np.zeros((4, 8, sc.n_features), np.float32)
    for rt in (ref, port):
        with pytest.raises(ValueError, match=r"tick batch must be \(n_devices=6"):
            rt.tick(batch)


def test_detection_ring_keeps_the_newest_events_as_in_reference():
    """``detections`` is a ring of ``detections_cap`` (tick, device) events:
    with more fresh detections than the cap, both runtimes keep the same
    newest ones, and ``detection_stats`` scores the same ring."""
    from repro.scenarios.evaluate import detection_stats as ref_detection_stats
    from repro_torch.scenarios.evaluate import detection_stats

    cap = 5
    sc, ref, port = _pair("star", 1.0, "short", ticks=RING_TICKS, detections_cap=cap)
    feed = sc.feed()
    for t in range(feed.n_ticks):
        _assert_same_report(port.tick(feed.tick_batch(t)), ref.tick(feed.tick_batch(t)),
                            losses=False)
    assert port.detections_total == ref.detections_total > cap
    assert list(port.detections) == list(ref.detections)
    assert len(port.detections) == cap
    kw = dict(truncated_devices=feed.truncated_drift_devices)
    assert (detection_stats(port.detections, feed.drift_ticks(), **kw)
            == ref_detection_stats(ref.detections, feed.drift_ticks(), **kw))


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
