"""The port's stale merges against the reference on the CPU.

- ``StalenessSchedule`` is a numpy copy: bit-identical lags from the same
  seed, the same validations.
- ``lagged_gather`` picks the reference's versions and refuses a ring too
  short for the schedule, as ``_lagged_gather`` does.
- ``fleet_train_async`` against the reference's on star, ring hops 2 and
  isolated hierarchical with random lags. The port mixes the lagged
  payloads through the topology's sparse kernels and solves by
  Gauss-Jordan; the reference mixes by a dense product over M − I and
  solves by Cholesky. The reference's own chain with a Gauss-Jordan solve
  (the jnp sweep of ``tests/test_torch_topology_merge.py``, pivot row
  left out of its own step) in place of its Cholesky solve strays up to
  1.4e-6 (relative to max |β|) from its Cholesky chain; the port, whose
  fused ingest also sums in another order than the reference's XLA
  ingest, is held at the larger of twice that spread and 1e-5, the
  reference's bound for a k=1 chain (measured: up to 3.5e-6). The
  reference's Pallas Gauss-Jordan kernel, whose pivot row carries its
  rounding times the pivot, strayed up to 2e-4 and set the bound before.
- With lag 0 everywhere ``fleet_train_async`` is ``fleet_train_rounds``
  bit for bit: the merged payload (fresh − stale) + mix(stale) is then the
  synchronous mix itself, summed in the same order.
- The stale runtime against the reference's ``FleetRuntime(staleness=…)``
  tick by tick: flags and merge decisions equal; losses at 1e-5 up to the
  first merge. After it the bound is 2e-4 (ROADMAP queue 3) or twice the
  reference's own Cholesky-versus-Gauss-Jordan spread on the same ticks
  (the Gauss-Jordan twin solves by the jnp sweep), whichever is larger
  (measured: the port up to 1.4e-5, the twin up to 2.2e-6). A stale runtime with lag 0 is the fresh
  runtime bit for bit, and the two refusals of the reference hold.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fleet.staleness as ref_staleness
import repro.runtime.runtime as ref_runtime
from repro.fleet import (
    FaultInjector as RefFaultInjector,
    FaultSpec as RefFaultSpec,
    StalenessSchedule as RefSchedule,
    fleet_train_async as ref_fleet_train_async,
    hierarchical as ref_hierarchical,
    ring as ref_ring,
    star as ref_star,
)
from repro.fleet.staleness import _lagged_gather as ref_lagged_gather
from repro.runtime import (
    FleetRuntime as RefRuntime,
    GovernorConfig as RefGovernorConfig,
    RuntimeConfig as RefRuntimeConfig,
)
from repro.scenarios import make_scenario
from repro_torch.convert import oselm_state_from_numpy
from repro_torch.fleet import (
    FaultInjector,
    FaultSpec,
    RobustConfig,
    StalenessSchedule,
    fleet_train_async,
    fleet_train_rounds,
    hierarchical,
    ring,
    star,
)
from repro_torch.fleet.staleness import lagged_gather
from repro_torch.runtime import DetectorConfig, FleetRuntime, GovernorConfig, RuntimeConfig

from test_torch_fleet_rounds import STEPS, _rel, round_inputs  # noqa: F401
from test_torch_topology_merge import D_ODD, RIDGE, _jnp_gj_solve, _port

torch.set_num_threads(2)

TOPOS = {
    "star": (star, ref_star),
    "ring2": (lambda d: ring(d, 2), lambda d: ref_ring(d, 2)),
    "hierarchical_isolated": (
        lambda d: hierarchical(d, 3, head_exchange=False),
        lambda d: ref_hierarchical(d, 3, head_exchange=False),
    ),
}


def _gauss_jordan_from_uv(states, uv, *, ridge=0.0, nonfinite="error"):
    """The reference's per-device solve by Gauss-Jordan: the jnp sweep of
    ``tests/test_torch_topology_merge.py`` (the reference's kernel sweep
    with the pivot row left out of its own step, as the port's)."""
    p, beta = _jnp_gj_solve(uv.u, uv.v, float(ridge))
    return states.replace(beta=beta, p=p)


# ------------------------------------------------------------- schedule


@pytest.mark.parametrize("seed,max_lag,stragglers", [(0, 3, 0.0), (1, 2, 0.25), (7, 5, 0.1),
                                                     (3, 0, 0.5)])
def test_schedule_is_bit_identical_with_the_reference(seed, max_lag, stragglers):
    for d in (D_ODD, 256):
        got = StalenessSchedule.random(d, max_lag, seed=seed, stragglers=stragglers)
        want = RefSchedule.random(d, max_lag, seed=seed, stragglers=stragglers)
        assert got.lags.dtype == want.lags.dtype
        np.testing.assert_array_equal(got.lags, want.lags)
        assert got.max_lag == want.max_lag
    np.testing.assert_array_equal(StalenessSchedule.uniform(5, 2).lags,
                                  RefSchedule.uniform(5, 2).lags)


def test_schedule_validation():
    for sched in (StalenessSchedule, RefSchedule):
        with pytest.raises(ValueError, match=">= 0"):
            sched(np.asarray([0, -1, 2]))
        with pytest.raises(ValueError, match="vector"):
            sched(np.zeros((2, 2), np.int32))


# --------------------------------------------------------- lagged gather


def test_lagged_gather_rejects_short_history():
    hist = torch.zeros((2, 4, 3, 3))
    with pytest.raises(ValueError, match="history"):
        lagged_gather(hist, np.asarray([0, 1, 2, 0]), 5)
    with pytest.raises(ValueError, match="history"):
        ref_lagged_gather(jnp.zeros((2, 4, 3, 3)), jnp.asarray([0, 1, 2, 0]), 5)
    # in-range lags pass
    lagged_gather(hist, np.asarray([0, 1, 1, 0]), 5)
    lagged_gather(hist, torch.tensor([0, 1, 1, 0]), 5)


@pytest.mark.parametrize("r", [0, 1, 2, 5, 11])
def test_lagged_gather_picks_the_reference_versions(r):
    rng = np.random.default_rng(r)
    hist = rng.standard_normal((4, D_ODD, 3, 5)).astype(np.float32)
    lags = RefSchedule.random(D_ODD, 3, seed=r).lags
    want = np.asarray(ref_lagged_gather(jnp.asarray(hist), jnp.asarray(lags), r))
    got = lagged_gather(torch.from_numpy(hist), lags, r)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ async rounds


def test_fleet_train_async_validation(round_inputs):  # noqa: F811
    fleet, streams = round_inputs
    port = _port(fleet)
    topo = star(D_ODD)
    sched = StalenessSchedule.uniform(D_ODD, 2)
    with pytest.raises(ValueError, match="history"):
        fleet_train_async(port, streams, topo, sched, rounds=2, ridge=RIDGE, history=2)
    with pytest.raises(ValueError, match="history"):
        ref_fleet_train_async(fleet, jnp.asarray(streams), ref_star(D_ODD),
                              RefSchedule.uniform(D_ODD, 2), rounds=2, ridge=RIDGE, history=2)
    with pytest.raises(ValueError, match="mismatch"):
        fleet_train_async(port, streams, star(D_ODD - 1), sched, rounds=2, ridge=RIDGE)
    with pytest.raises(ValueError, match="mismatch"):
        fleet_train_async(port, streams, topo, StalenessSchedule.uniform(3, 0), rounds=2)
    for rounds in (0, STEPS + 1):
        with pytest.raises(ValueError, match="rounds"):
            fleet_train_async(port, streams, topo, sched, rounds=rounds, ridge=RIDGE)


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_fleet_train_async_matches_reference(round_inputs, topo_name, monkeypatch):  # noqa: F811
    port_fn, ref_fn = TOPOS[topo_name]
    fleet, streams = round_inputs
    lags = RefSchedule.random(D_ODD, max_lag=3, seed=0, stragglers=0.25).lags
    xs = jnp.asarray(streams)
    want = ref_fleet_train_async(fleet, xs, ref_fn(D_ODD), RefSchedule(lags), rounds=4,
                                 ridge=RIDGE)
    with monkeypatch.context() as m:
        m.setattr(ref_staleness, "fleet_from_uv", _gauss_jordan_from_uv)
        twin = ref_fleet_train_async(fleet, xs, ref_fn(D_ODD), RefSchedule(lags), rounds=4,
                                     ridge=RIDGE)
    got = fleet_train_async(_port(fleet), streams, port_fn(D_ODD), StalenessSchedule(lags),
                            rounds=4, ridge=RIDGE)
    spread = {k: _rel(getattr(twin, k), getattr(want, k)) for k in ("p", "beta")}
    dev = {k: _rel(getattr(got, k).numpy(), getattr(want, k)) for k in ("p", "beta")}
    print(f"{topo_name}: port vs reference {dev}; the reference's Gauss-Jordan twin vs its "
          f"Cholesky run {spread}")
    for k in ("p", "beta"):
        assert dev[k] <= max(1e-5, 2 * spread[k]), (topo_name, k, dev, spread)
    # the lags matter: the same rounds without staleness land elsewhere
    sync = fleet_train_rounds(_port(fleet), streams, port_fn(D_ODD), rounds=4, ridge=RIDGE)
    assert torch.isfinite(got.beta).all()
    assert float((got.beta - sync.beta).abs().max()) > 1e-6


@pytest.mark.parametrize("history", [None, 3])
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_zero_lag_is_the_synchronous_rounds_bit_for_bit(round_inputs, topo_name, history):  # noqa: F811
    port_fn, _ = TOPOS[topo_name]
    fleet, streams = round_inputs
    sync = fleet_train_rounds(_port(fleet), streams, port_fn(D_ODD), rounds=4, ridge=RIDGE)
    azero = fleet_train_async(_port(fleet), streams, port_fn(D_ODD),
                              StalenessSchedule.uniform(D_ODD, 0), rounds=4, ridge=RIDGE,
                              history=history)
    assert torch.equal(azero.p, sync.p) and torch.equal(azero.beta, sync.beta)


# --------------------------------------------------------------- runtime

SPEC_ODD = dict(n_devices=5, ticks=16, batch=3, n_hidden=10)
SHORT_DETECTOR = dict(warmup=3, warmup_skip=1, rel_sigma=0.05, k_sigma=1.0, patience=2)
RT_TOPOS = {
    "star": (star, ref_star),
    "ring": (lambda d: ring(d, 1), lambda d: ref_ring(d, 1)),
    "hierarchical_isolated": (
        lambda d: hierarchical(d, 2, head_exchange=False),
        lambda d: ref_hierarchical(d, 2, head_exchange=False),
    ),
}


def _scenario():
    base = make_scenario("har", **SPEC_ODD).detector
    return make_scenario("har", **SPEC_ODD,
                         detector=dataclasses.replace(base, **SHORT_DETECTOR)).build()


def _port_runtime(sc, fleet, topo, lags, **over):
    port_fleet = oselm_state_from_numpy(
        fleet.params.alpha, fleet.params.bias, fleet.beta, fleet.p,
        activation=fleet.activation, forget=fleet.forget, device="cpu",
    )
    cfg = dict(topology=topo, ridge=sc.spec.ridge,
               detector=DetectorConfig(**dataclasses.asdict(sc.spec.detector)),
               governor=GovernorConfig(merge_every=4),
               staleness=None if lags is None else StalenessSchedule(lags))
    cfg.update(over)
    return FleetRuntime(port_fleet, RuntimeConfig(**cfg), device="cpu")


@pytest.mark.parametrize("topo_name", sorted(RT_TOPOS))
def test_stale_runtime_matches_reference(topo_name, monkeypatch):
    port_fn, ref_fn = RT_TOPOS[topo_name]
    sc = _scenario()
    fleet = sc.init_fleet(jax.random.PRNGKey(0))
    d = sc.spec.n_devices
    lags = RefSchedule.random(d, max_lag=2, seed=1).lags

    def reference():
        rt = RefRuntime(fleet, RefRuntimeConfig(
            topology=ref_fn(d), ridge=sc.spec.ridge, detector=sc.spec.detector,
            governor=RefGovernorConfig(merge_every=4), use_ingest_kernel=True,
            ingest_backend="pallas", staleness=RefSchedule(lags),
        ))
        rt.warmup(sc.spec.batch)  # traces its stale merge now
        return rt

    ref = reference()
    with monkeypatch.context() as m:
        m.setattr(ref_runtime, "fleet_from_uv", _gauss_jordan_from_uv)
        twin = reference()
    port = _port_runtime(sc, fleet, port_fn(d), lags)
    port.warmup(sc.spec.batch)
    feed = sc.feed()
    merges = flags = 0
    port_dev, twin_dev = [], []
    for t in range(feed.n_ticks):
        batch = feed.tick_batch(t)
        want, got, other = ref.tick(batch), port.tick(batch), twin.tick(batch)
        for rep in (got, other):
            assert np.array_equal(rep.drifted, want.drifted), t
            assert np.array_equal(rep.fresh_detections, want.fresh_detections), t
            assert (rep.decision.merge, rep.decision.reason, rep.decision.participants,
                    rep.decision.round_bytes) == (
                want.decision.merge, want.decision.reason, want.decision.participants,
                want.decision.round_bytes), t
        if not merges:  # up to and with the first merge's tick
            np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5, atol=1e-6)
        port_dev.append(float(np.max(np.abs(got.losses - want.losses) / np.abs(want.losses))))
        twin_dev.append(float(np.max(np.abs(other.losses - want.losses) / np.abs(want.losses))))
        merges += want.decision.merge
        flags += int(want.fresh_detections.sum())
    assert merges >= 3 and flags > 0, "the differential lost its teeth"
    assert port.merge_round == ref.merge_round == merges
    bound = max(2e-4, 2 * max(twin_dev))
    print(f"{topo_name}: losses, port vs reference per tick {np.round(port_dev, 7).tolist()};"
          f" the reference's Gauss-Jordan twin {np.round(twin_dev, 7).tolist()}; bound {bound:.2e}")
    assert max(port_dev) <= bound


@pytest.mark.parametrize("topo_name", sorted(RT_TOPOS))
def test_zero_lag_stale_runtime_is_the_fresh_runtime(topo_name):
    port_fn, _ = RT_TOPOS[topo_name]
    sc = _scenario()
    fleet = sc.init_fleet(jax.random.PRNGKey(0))
    d = sc.spec.n_devices
    stale = _port_runtime(sc, fleet, port_fn(d), np.zeros(d, np.int32))
    fresh = _port_runtime(sc, fleet, port_fn(d), None)
    stale.warmup(sc.spec.batch)
    feed = sc.feed()
    merges = 0
    for t in range(feed.n_ticks):
        a, b = stale.tick(feed.tick_batch(t)), fresh.tick(feed.tick_batch(t))
        np.testing.assert_array_equal(a.losses, b.losses)
        assert a.decision == b.decision
        merges += a.decision.merge
    assert merges >= 3
    assert torch.equal(stale.states.p, fresh.states.p)
    assert torch.equal(stale.states.beta, fresh.states.beta)


def test_stale_runtime_refusals():
    sc = make_scenario("har", **SPEC_ODD).build()
    fleet = sc.init_fleet(jax.random.PRNGKey(0))
    d = sc.spec.n_devices
    lags = np.ones(d, np.int32)
    with pytest.raises(ValueError, match="stale"):
        _port_runtime(sc, fleet, star(d), lags, payload_precision="int8")
    with pytest.raises(ValueError, match="stale"):
        RefRuntime(fleet, RefRuntimeConfig(topology=ref_star(d), payload_precision="int8",
                                           staleness=RefSchedule(lags)))
    with pytest.raises(ValueError, match="stale"):
        _port_runtime(sc, fleet, star(d), lags, robust=RobustConfig())
    with pytest.raises(ValueError, match="stale"):
        _port_runtime(sc, fleet, star(d), lags,
                      faults=FaultInjector((FaultSpec(kind="nan", devices=(1,)),), d))
    with pytest.raises(ValueError, match="stale"):
        RefRuntime(fleet, RefRuntimeConfig(
            topology=ref_star(d), staleness=RefSchedule(lags),
            faults=RefFaultInjector((RefFaultSpec(kind="nan", devices=(1,)),), d)))
    with pytest.raises(ValueError, match="device count"):
        _port_runtime(sc, fleet, star(d), np.ones(d + 1, np.int32))


def test_warmup_leaves_the_ring_as_it_was():
    sc = _scenario()
    fleet = sc.init_fleet(jax.random.PRNGKey(0))
    d = sc.spec.n_devices
    rt = _port_runtime(sc, fleet, ring(d, 1), np.asarray([2, 0, 1, 2, 2], np.int32))
    feed = sc.feed()
    for t in range(5):  # one merge, at tick 3
        rt.tick(feed.tick_batch(t))
    ring_before, p_before = rt._hist.clone(), rt.states.p.clone()
    rt.warmup(sc.spec.batch)
    assert torch.equal(rt._hist, ring_before) and torch.equal(rt.states.p, p_before)
    assert rt.merge_round == 1
