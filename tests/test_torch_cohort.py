"""The port's cohort-paged arena (``repro_torch.fleet.arena``,
``repro_torch.fleet.sharded``, ``repro_torch.runtime.cohort``,
``fleet_ingest_paged``, ``common_mode_ratio``) against the reference's on
the CPU, on the fixture of ``tests/test_cohort.py`` (D = 32, cohorts of 8,
F = 8, Ñ = 4, B = 4, ridge 1e-2), handed over as numpy arrays.

Bounds are the reference's own (``tests/test_cohort.py``): the two-tier
merge within 1e-5 of the flat merge and of the reference's ``CohortMerger``
(its XLA tier 1) on every claimed topology, non-participants bit for bit;
the paged runtime's reports against the reference's paged runtime and the
port's resident ``FleetRuntime`` over 12 ticks with flags, fresh detections
and decisions equal, losses at rtol 1e-5 / atol 1e-6 up to the first merge,
and after it, where the port's Gauss-Jordan merges amplify the tree's other
order of adds, at the larger of that bound (β 5e-5 at the end) and twice
the reference's own spread between the matching pair of its runs
(``test_paged_runtime_matches_reference_and_resident``). ``init_arena`` is held to the port's ``init_fleet`` from the same
generator and boot chunks at rtol 1e-4 / atol 1e-5 (the reference's own
arena-init test fails on this tree, so it is no oracle here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet import CohortMerger as RefCohortMerger
from repro.fleet import CohortSchedule as RefCohortSchedule
from repro.fleet import FleetArena as RefFleetArena
from repro.fleet import all_to_all as ref_all_to_all
from repro.fleet import cohort_round_cost as ref_cohort_round_cost
from repro.fleet import hierarchical as ref_hierarchical
from repro.fleet import init_fleet as ref_init_fleet
from repro.fleet import ring as ref_ring
from repro.fleet import star as ref_star
from repro.fleet.sharded import _tree_fold as ref_tree_fold
from repro.kernels.fleet_ingest import fleet_ingest_paged as ref_fleet_ingest_paged
from repro.runtime import CohortFleetRuntime as RefCohortRuntime
from repro.runtime import DetectorConfig as RefDetectorConfig
from repro.runtime import FleetRuntime as RefFleetRuntime
from repro.runtime import GovernorConfig as RefGovernorConfig
from repro.runtime import RuntimeConfig as RefRuntimeConfig
from repro.runtime.detector import DetectorState as RefDetectorState
from repro.runtime.detector import common_mode_ratio as ref_common_mode_ratio
from repro.runtime.detector import detector_update as ref_detector_update
from repro_torch.convert import detector_state_from_numpy, oselm_state_from_numpy
from repro_torch.core import OSELMState, SLFNParams
from repro_torch.fleet import (
    CohortMerger,
    CohortSchedule,
    FleetArena,
    TierCost,
    all_to_all,
    cohort_round_cost,
    cohort_tree_reduce,
    fleet_merge_masked_kernel,
    hierarchical,
    init_arena,
    init_fleet,
    ring,
    star,
)
from repro_torch.fleet.sharded import _tree_fold
from repro_torch.fleet.topology import Topology
from repro_torch.kernels import fleet_ingest, fleet_ingest_paged
from repro_torch.launch.mesh import Mesh
from repro_torch.runtime import (
    CohortFleetRuntime,
    DetectorConfig,
    FleetRuntime,
    GovernorConfig,
    RuntimeConfig,
    common_mode_ratio,
    detector_update,
)

torch.set_num_threads(2)

D, C, F, NH, B = 32, 8, 8, 4, 4
RIDGE = 1e-2
N_INIT = 16
TICKS = 12


@pytest.fixture(scope="module")
def ref_fleet():
    x0 = jax.random.normal(jax.random.PRNGKey(0), (D, N_INIT, F)) * 0.5
    return ref_init_fleet(jax.random.PRNGKey(1), D, F, NH, x0, ridge=RIDGE)


@pytest.fixture(scope="module")
def fleet(ref_fleet):
    return oselm_state_from_numpy(
        ref_fleet.params.alpha, ref_fleet.params.bias, ref_fleet.beta, ref_fleet.p,
        activation=ref_fleet.activation, forget=ref_fleet.forget, device="cpu")


def _arena(fleet) -> FleetArena:
    return FleetArena.from_fleet(fleet)


def _config(topology, **kw) -> RuntimeConfig:
    return RuntimeConfig(topology=topology, ridge=RIDGE,
                         detector=DetectorConfig(warmup=4, warmup_skip=1),
                         governor=GovernorConfig(merge_every=3), **kw)


def _ref_config(topology) -> RefRuntimeConfig:
    return RefRuntimeConfig(topology=topology, ridge=RIDGE,
                            detector=RefDetectorConfig(warmup=4, warmup_skip=1),
                            governor=RefGovernorConfig(merge_every=3),
                            use_ingest_kernel=True, ingest_backend="xla")


# ------------------------------------------------------------------ arena


def test_arena_from_fleet_roundtrip(fleet, ref_fleet):
    arena = _arena(fleet)
    assert (arena.n_devices, arena.n_hidden, arena.n_out, arena.n_features) == (D, NH, F, F)
    assert tuple(arena.alpha.shape) == (F, NH)  # stored once, not (D, F, NH)
    back = arena.to_fleet(device="cpu")
    assert torch.equal(back.p, fleet.p) and torch.equal(back.beta, fleet.beta)
    assert torch.equal(back.params.alpha, fleet.params.alpha)
    assert back.params.alpha.ndim == 2 and back.p.data_ptr() != arena.p.data_ptr()
    ref = RefFleetArena.from_fleet(ref_fleet)
    np.testing.assert_array_equal(arena.p.numpy(), ref.p)
    np.testing.assert_array_equal(arena.beta.numpy(), ref.beta)
    np.testing.assert_array_equal(arena.alpha.numpy(), ref.alpha)
    assert arena.nbytes == ref.nbytes == (
        arena.alpha.numel() * 4 + arena.bias.numel() * 4 + 4 * D * (NH * NH + NH * F))


def test_arena_page_is_a_view(fleet):
    arena = _arena(fleet)
    page = arena.page(8, 16)
    assert tuple(page.p.shape) == (8, NH, NH) and page.params.alpha.ndim == 2
    assert page.p.data_ptr() == arena.p[8].data_ptr()  # no copy
    assert page.beta.data_ptr() == arena.beta[8].data_ptr()
    p0 = arena.p.clone()
    arena.write_page(8, 16, np.zeros((8, NH, NH)), np.zeros((8, NH, F)),
                     where=np.arange(8) < 2)
    assert bool((arena.p[8:10] == 0).all()) and not bool((arena.p[10:16] == 0).all())
    assert torch.equal(arena.p[10:], p0[10:]) and torch.equal(arena.p[:8], p0[:8])
    arena.write_page(0, 8, torch.ones((8, NH, NH)), torch.ones((8, NH, F)))
    assert bool((arena.p[:8] == 1).all()) and bool((arena.beta[:8] == 1).all())


def test_arena_rejects_per_device_bases(fleet):
    alpha = fleet.params.alpha[None].repeat(D, 1, 1)
    bias = fleet.params.bias[None].repeat(D, 1)
    shared = fleet.replace(params=SLFNParams(alpha=alpha, bias=bias))
    assert torch.equal(FleetArena.from_fleet(shared).alpha, fleet.params.alpha)
    bad = fleet.replace(params=SLFNParams(alpha=alpha.clone().index_add_(
        0, torch.tensor([0]), torch.ones((1, F, NH))), bias=bias))
    with pytest.raises(ValueError, match="share"):
        FleetArena.from_fleet(bad)
    with pytest.raises(ValueError, match="D"):
        FleetArena(alpha=fleet.params.alpha, bias=fleet.params.bias, p=fleet.p,
                   beta=fleet.beta[:-1])


def test_init_arena_matches_init_fleet():
    """Paged Eq. 13 equals the resident ``init_fleet`` from the same
    generator and boot chunks."""
    x0 = (np.random.default_rng(3).standard_normal((D, N_INIT, F)) * 0.5).astype(np.float32)
    arena = init_arena(torch.Generator().manual_seed(4), D, F, NH, lambda lo, hi: x0[lo:hi],
                       cohort_size=C, ridge=RIDGE, device="cpu")
    resident = init_fleet(torch.Generator().manual_seed(4), D, F, NH, x0, ridge=RIDGE,
                          device="cpu")
    assert torch.equal(arena.alpha, resident.params.alpha)
    assert torch.equal(arena.bias, resident.params.bias)
    np.testing.assert_allclose(arena.p.numpy(), resident.p.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(arena.beta.numpy(), resident.beta.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="bottleneck"):
        init_arena(torch.Generator(), D, F, F, lambda lo, hi: x0[lo:hi], cohort_size=C,
                   device="cpu")
    with pytest.raises(ValueError, match="boot chunk"):
        init_arena(torch.Generator(), D, F, NH, lambda lo, hi: x0[:2], cohort_size=C,
                   device="cpu")


def test_entry_points_default_to_the_card(fleet):
    """With no card, the entry points raise unless given ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_arena(torch.Generator(), D, F, NH, lambda lo, hi: np.zeros((hi - lo, 8, F)),
                   cohort_size=C)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CohortMerger(star(D), CohortSchedule(D, C))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CohortFleetRuntime(_arena(fleet), _config(star(D)), cohort_size=C)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _arena(fleet).to_fleet()


# --------------------------------------------------------------- schedule


def test_schedule_validation():
    for bad, match in (((32, 5), "divisible"), ((32, 64), "cohort_size"),
                       ((32, 8, 5), "active_per_tick")):
        with pytest.raises(ValueError, match=match):
            CohortSchedule(*bad)
        with pytest.raises(ValueError, match=match):
            RefCohortSchedule(*bad)
    s, r = CohortSchedule(32, 8), RefCohortSchedule(32, 8)
    assert s.n_cohorts == r.n_cohorts == 4
    assert s.bounds(2) == r.bounds(2) == (16, 24)
    assert s.bounds() == r.bounds() == [(0, 8), (8, 16), (16, 24), (24, 32)]


@pytest.mark.parametrize("active", [None, 1, 2, 3, 4])
def test_schedule_rotation_matches_reference(active):
    s, r = CohortSchedule(32, 8, active), RefCohortSchedule(32, 8, active)
    assert [s.active(t) for t in range(9)] == [r.active(t) for t in range(9)]
    served = set()
    for t in range(-(-4 // (active or 4))):
        served.update(s.active(t))
    assert served == {0, 1, 2, 3}


# -------------------------------------------------------- two-tier merges

def _claimed():
    """(port, reference) topology pairs: star, all_to_all, open rings,
    the closed ring, hierarchical with head exchange, and isolated clusters
    nested in cohorts, straddling their bounds and two a cohort."""
    return [
        (star(D), ref_star(D)),
        (all_to_all(D), ref_all_to_all(D)),
        (ring(D, hops=2), ref_ring(D, hops=2)),
        (ring(D, hops=9), ref_ring(D, hops=9)),
        (ring(D, hops=D // 2), ref_ring(D, hops=D // 2)),
        (hierarchical(D, 4), ref_hierarchical(D, 4)),
        (hierarchical(D, 4, head_exchange=False), ref_hierarchical(D, 4, head_exchange=False)),
        (hierarchical(D, 6, head_exchange=False), ref_hierarchical(D, 6, head_exchange=False)),
        (hierarchical(D, 16, head_exchange=False),
         ref_hierarchical(D, 16, head_exchange=False)),
    ]


CLAIMED = _claimed()
CLAIMED_IDS = [f"{t.name}_{t.n_clusters or t.hops or ''}" for t, _ in CLAIMED]


@pytest.mark.parametrize("pair", CLAIMED, ids=CLAIMED_IDS)
def test_two_tier_merge_matches_flat_and_reference(fleet, ref_fleet, pair):
    """Eq. 8 through the cohort tree equals the port's flat masked merge and
    the reference's two-tier merge within 1e-5 under a participation mask;
    non-participants keep their rows bit for bit."""
    topology, ref_topology = pair
    rng = np.random.default_rng(42)
    mask = rng.random(D) > 0.25
    mask[:2] = True
    arena = _arena(fleet)
    merger = CohortMerger(topology, CohortSchedule(D, C), ridge=RIDGE, device="cpu")
    cost = merger.merge(arena, mask)
    flat = fleet_merge_masked_kernel(fleet, topology, torch.as_tensor(mask, dtype=torch.float32),
                                     ridge=RIDGE)
    np.testing.assert_allclose(arena.beta.numpy(), flat.beta.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(arena.p.numpy(), flat.p.numpy(), rtol=1e-5, atol=1e-5)
    ref_arena = RefFleetArena.from_fleet(ref_fleet)
    ref_cost = RefCohortMerger(ref_topology, RefCohortSchedule(D, C), ridge=RIDGE,
                               kernel=False).merge(ref_arena, mask)
    np.testing.assert_allclose(arena.beta.numpy(), ref_arena.beta, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(arena.p.numpy(), ref_arena.p, rtol=1e-5, atol=1e-5)
    skip = torch.as_tensor(~mask)
    assert torch.equal(arena.beta[skip], fleet.beta[skip])
    assert torch.equal(arena.p[skip], fleet.p[skip])
    assert dataclasses.asdict(cost) == dataclasses.asdict(ref_cost) and cost.bytes_total > 0
    assert merger.mode == {"segment": "clusters", "banded": "ring"}.get(
        topology.kind if not topology.is_fully_connected else "", "global")


def test_star_merge_collapses_fleet_to_one_state(fleet):
    """A full-participation star round solves one global (ΣU, ΣV) and every
    device row lands bit-identical across the cohort pages."""
    arena = _arena(fleet)
    CohortMerger(star(D), CohortSchedule(D, C), ridge=RIDGE, device="cpu").merge(
        arena, np.ones(D, bool))
    assert torch.equal(arena.p, arena.p[:1].expand_as(arena.p))
    assert torch.equal(arena.beta, arena.beta[:1].expand_as(arena.beta))


def test_merger_routes_and_rejects_undecomposable_topologies(fleet):
    sched = CohortSchedule(D, C)
    assert CohortMerger(star(D), sched, device="cpu").launches_per_round() == {
        "masked_segment_sum_mix": 4, "from_uv_solve": 1}
    assert CohortMerger(hierarchical(D, 6, head_exchange=False), sched,
                        device="cpu").launches_per_round() == {
        "masked_segment_sum_mix": 4, "from_uv_solve": 1}
    assert CohortMerger(ring(D, 2), sched, device="cpu").launches_per_round() == {
        "from_uv_solve": 4}
    scrambled = Topology(name="scrambled", n_devices=D, kind="segment",
                         cluster_ids=np.array([0, 1] * (D // 2), np.int32), n_clusters=2,
                         head_exchange=False, payloads_per_round=2 * D)
    with pytest.raises(ValueError, match="sorted"):
        CohortMerger(scrambled, sched, device="cpu")
    dense = Topology(name="arbitrary_dense", n_devices=D, kind="dense",
                     matrix=np.eye(D, dtype=np.float32), payloads_per_round=0)
    with pytest.raises(NotImplementedError):
        CohortMerger(dense, sched, device="cpu")
    with pytest.raises(ValueError, match="D="):
        CohortMerger(star(2 * D), sched, device="cpu")
    merger = CohortMerger(star(D), sched, device="cpu")
    with pytest.raises(ValueError, match="mask"):
        merger.merge(_arena(fleet), np.ones(D + 1, bool))


def test_merger_warmup_changes_nothing(fleet):
    for topo in (star(D), hierarchical(D, 6, head_exchange=False), ring(D, 2)):
        arena = _arena(fleet)
        CohortMerger(topo, CohortSchedule(D, C), ridge=RIDGE, device="cpu").warmup(arena)
        assert torch.equal(arena.p, fleet.p) and torch.equal(arena.beta, fleet.beta)


class _Shards:
    """A mesh of ``n`` shards seen from shard 0 of one process: its
    all-reduce is the identity, as one rank's is (the multi-process runs are
    ``tests/test_torch_sharded.py``'s)."""

    device = torch.device("cpu")

    def __init__(self, n):
        self.n = n

    def size(self, axes):
        return self.n

    def index(self, axes):
        return 0

    block = Mesh.block

    def all_reduce(self, t, axes):
        return t.clone()


def test_mesh_is_not_ported(fleet):
    """The mesh branch (ported since the multi-process merges): one shard
    reduces as the tree does and merges as ``mesh=None`` does, bit for bit;
    cohorts that do not divide over the shards are refused."""
    stack = torch.from_numpy(np.random.default_rng(3).normal(size=(4, NH, NH + F))
                             .astype(np.float32))
    assert torch.equal(cohort_tree_reduce(stack, mesh=_Shards(1)), _tree_fold(stack))
    with pytest.raises(ValueError, match="not divisible by 3 mesh shards"):
        cohort_tree_reduce(stack, mesh=_Shards(3))
    with pytest.raises(ValueError, match="not divisible by 3 mesh shards"):
        CohortMerger(star(D), CohortSchedule(D, C), mesh=_Shards(3), device="cpu")
    mask = np.random.default_rng(4).random(D) < 0.7
    arenas = [_arena(fleet) for _ in range(2)]
    for arena, mesh in zip(arenas, (None, _Shards(1))):
        CohortMerger(star(D), CohortSchedule(D, C), ridge=RIDGE, mesh=mesh,
                     device="cpu").merge(arena, mask)
    assert torch.equal(arenas[0].p, arenas[1].p) and torch.equal(arenas[0].beta, arenas[1].beta)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8])
def test_cohort_tree_reduce_matches_sum_and_the_reference_order(n):
    stack = np.random.default_rng(n).normal(size=(n, NH, NH + F)).astype(np.float32)
    out = cohort_tree_reduce(torch.from_numpy(stack))
    np.testing.assert_allclose(out.numpy(), stack.sum(axis=0), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_tree_fold(torch.from_numpy(stack)).numpy(),
                                  np.asarray(ref_tree_fold(jnp.asarray(stack))))
    np.testing.assert_array_equal(cohort_tree_reduce(stack).numpy(), out.numpy())


# ----------------------------------------------------------- tier costs

@pytest.mark.parametrize("pair", CLAIMED, ids=CLAIMED_IDS)
@pytest.mark.parametrize("cohort", [4, 8, 16])
def test_tier_cost_matches_reference(pair, cohort):
    topology, ref_topology = pair
    got = cohort_round_cost(topology, CohortSchedule(D, cohort), NH, F)
    want = ref_cohort_round_cost(ref_topology, RefCohortSchedule(D, cohort), NH, F)
    assert isinstance(got, TierCost)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.bytes_tier1, got.bytes_tier2, got.bytes_total) == (
        want.bytes_tier1, want.bytes_tier2, want.bytes_total)


def test_tier_cost_accounting():
    sched = CohortSchedule(D, C)
    c = cohort_round_cost(star(D), sched, NH, F)
    assert (c.tier1_payloads, c.tier2_payloads) == (2 * (D - 4), 2 * 3)
    assert c.bytes_total == c.bytes_tier1 + c.bytes_tier2
    assert cohort_round_cost(hierarchical(D, 4, head_exchange=False), sched, NH,
                             F).tier2_payloads == 0
    c = cohort_round_cost(hierarchical(D, 6, head_exchange=False), sched, NH, F)
    assert 0 < c.tier2_payloads < 2 * 6 * sched.n_cohorts
    c = cohort_round_cost(ring(D, hops=2), sched, NH, F)
    assert c.tier2_payloads == 2 * 2 * sched.n_cohorts < c.tier1_payloads
    with pytest.raises(ValueError, match="D="):
        cohort_round_cost(star(D), CohortSchedule(2 * D, C), NH, F)


# ------------------------------------------------------- the detector

def _bank(seed: int, d: int = 64):
    rng = np.random.default_rng(seed)
    leaves = dict(
        ewma=rng.uniform(0.5, 2.0, d).astype(np.float32),
        mean=rng.uniform(0.5, 2.0, d).astype(np.float32),
        var=rng.uniform(0.0, 0.1, d).astype(np.float32),
        count=rng.integers(0, 8, d).astype(np.int32),
        drifted=rng.random(d) < 0.1,
        recovery=rng.integers(0, 3, d).astype(np.int32),
    )
    losses = rng.uniform(0.3, 3.0, d).astype(np.float32)
    losses[rng.random(d) < 0.1] = np.nan   # devices of cohorts not served this tick
    participants = rng.random(d) < 0.8
    return leaves, losses, participants


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_common_mode_ratio_and_detector_update_common_match_reference(seed):
    leaves, losses, participants = _bank(seed)
    cfg, ref_cfg = DetectorConfig(warmup=4, warmup_skip=1), RefDetectorConfig(warmup=4,
                                                                              warmup_skip=1)
    state = detector_state_from_numpy(**leaves, device="cpu")
    ref_state = RefDetectorState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    loss_t, part_t = torch.from_numpy(losses), torch.from_numpy(participants)
    got = common_mode_ratio(state, loss_t, cfg, participants=part_t)
    want = ref_common_mode_ratio(ref_state, jnp.asarray(losses), ref_cfg,
                                 participants=jnp.asarray(participants))
    assert float(got) == float(want)
    # the median is jnp's midpoint of the two middle values, not torch's lower one
    inside = np.isfinite(losses) & participants & ~leaves["drifted"] & (leaves["count"] >= 4)
    assert float(got) == pytest.approx(float(np.median(
        losses[inside] / np.maximum(leaves["mean"][inside], cfg.min_sigma))), rel=1e-6)
    # a given common (and the guard against a non-finite or non-positive one)
    # agrees with the reference's, and with the median taken in the update
    for common in (None, got, 0.7, -1.0, float("nan"), float("inf")):
        new, drifted, fresh = detector_update(state, loss_t, cfg, rebase=True,
                                              participants=part_t, common=common)
        rnew, rdrifted, rfresh = ref_detector_update(
            ref_state, jnp.asarray(losses), ref_cfg, rebase=True,
            participants=jnp.asarray(participants),
            common=None if common is None else jnp.float32(float(common)))
        for f in ("ewma", "mean", "var", "count", "drifted", "recovery"):
            np.testing.assert_array_equal(getattr(new, f).numpy(), np.asarray(getattr(rnew, f)),
                                          err_msg=f"{f} with common={common}")
        np.testing.assert_array_equal(drifted.numpy(), np.asarray(rdrifted))
        np.testing.assert_array_equal(fresh.numpy(), np.asarray(rfresh))
    by_median = detector_update(state, loss_t, cfg, rebase=True, participants=part_t)[0]
    fed = detector_update(state, loss_t, cfg, rebase=True, participants=part_t, common=got)[0]
    for f in ("ewma", "mean", "var"):  # NaN where a device was not served, in both
        np.testing.assert_array_equal(getattr(by_median, f).numpy(), getattr(fed, f).numpy())


# ------------------------------------------------- the paged ingest

@pytest.mark.parametrize("activation,forget", [("sigmoid", 1.0), ("identity", 0.97)])
def test_fleet_ingest_paged_matches_reference_and_the_stacked_ingest(ref_fleet, activation,
                                                                   forget):
    rng = np.random.default_rng(5)
    window = rng.normal(scale=0.5, size=(C, 2 * B, F)).astype(np.float32)
    p, beta = np.array(ref_fleet.p)[:C], np.array(ref_fleet.beta)[:C]
    alpha, bias = np.array(ref_fleet.params.alpha)[0], np.array(ref_fleet.params.bias)[0]
    got = fleet_ingest_paged(*(torch.from_numpy(np.array(x))
                               for x in (p, beta, alpha, bias, window)),
                             activation=activation, forget=forget)
    want = ref_fleet_ingest_paged(*(jnp.asarray(x) for x in (p, beta, alpha, bias, window)),
                                  activation=activation, forget=forget, backend="pallas")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    st = OSELMState(params=SLFNParams(torch.from_numpy(alpha), torch.from_numpy(bias)),
                    beta=torch.from_numpy(beta), p=torch.from_numpy(p),
                    activation=activation, forget=forget)
    trained, losses = fleet_ingest(st, torch.from_numpy(window))
    for g, w in zip(got, (trained.p, trained.beta, losses)):
        assert torch.equal(g, w)
    assert got[0].shape == (C, NH, NH) and got[1].shape == (C, NH, F) and got[2].shape == (C,)


# ------------------------------------------------- paged runtime

def _tick_batches(n_ticks: int, seed: int = 7, drift_dev: int | None = None,
                  drift_from: int = 10**9):
    rng = np.random.default_rng(seed)
    for t in range(n_ticks):
        batch = rng.normal(scale=0.5, size=(D, B, F)).astype(np.float32)
        if drift_dev is not None and t >= drift_from:
            batch[drift_dev] += 2.0
        yield batch


def _decision(report) -> tuple:
    d = report.decision
    return d.merge, d.reason, d.participants, d.round_bytes, d.fp_participants


RUNTIME_TOPOLOGIES = [
    (star(D), ref_star(D)),
    (hierarchical(D, 6, head_exchange=False), ref_hierarchical(D, 6, head_exchange=False)),
    (ring(D, hops=2), ref_ring(D, hops=2)),
]


def _rel(a, b) -> float:
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("pair", RUNTIME_TOPOLOGIES, ids=lambda p: p[0].name)
def test_paged_runtime_matches_reference_and_resident(fleet, ref_fleet, pair):
    """The paged runtime's reports against the reference's paged runtime
    (its XLA path, as ``tests/test_cohort.py`` runs it) and the port's
    resident runtime, tick by tick, through merge rounds, post-merge
    rebases and a drift detection: flags, fresh detections and decisions
    equal on every tick, losses at test_cohort.py's rtol 1e-5 / atol 1e-6
    up to the first merge.

    After it the port solves by Gauss-Jordan without pivoting, as the
    reference's kernel path does, and the two-tier tree's other order of
    adds moves that solve's last bits, which the following merges amplify
    by κ(U): on star the reference's own kernel path (Pallas ingest and
    merge) parts from itself, paged against resident, by 1.2e-4 on the
    losses and 3.5e-4 on β after 12 ticks, where its XLA path (Cholesky)
    stays within 4e-7. So after the first merge each comparison is held at
    the larger of test_cohort.py's bound (1e-5 on the losses, 5e-5 on β)
    and twice the reference's own spread between the matching pair of its
    runs on the same ticks: the port's paged against resident at twice the
    reference kernel path's paged-against-resident spread, the port's
    paged against the reference's XLA paged run at twice the spread of the
    reference's kernel paged run from its XLA one. Each spread is printed
    (``-s``)."""
    topology, ref_topology = pair
    paged = CohortFleetRuntime(_arena(fleet), _config(topology), cohort_size=C, device="cpu")
    resident = FleetRuntime(fleet, _config(topology), device="cpu")
    ref = RefCohortRuntime(RefFleetArena.from_fleet(ref_fleet), _ref_config(ref_topology),
                           cohort_size=C)
    kernel_cfg = dataclasses.replace(_ref_config(ref_topology), ingest_backend="pallas",
                                     use_merge_kernel=True)
    ref_kernel = RefCohortRuntime(RefFleetArena.from_fleet(ref_fleet), kernel_cfg,
                                  cohort_size=C)
    ref_kernel_resident = RefFleetRuntime(ref_fleet, kernel_cfg)
    dev = {"resident": 0.0, "ref": 0.0}
    spread = {"resident": 0.0, "ref": 0.0}
    merged = False
    for t, batch in enumerate(_tick_batches(TICKS, drift_dev=3, drift_from=8)):
        got = paged.tick(batch)
        pairs = {"resident": resident.tick(batch), "ref": ref.tick(batch)}
        twin = ref_kernel.tick(batch)
        twins = {"resident": ref_kernel_resident.tick(batch), "ref": pairs["ref"]}
        for name, other in pairs.items():
            assert np.array_equal(got.drifted, other.drifted), (name, t)
            assert np.array_equal(got.fresh_detections, other.fresh_detections), (name, t)
            assert _decision(got) == _decision(other), (name, t, got.decision, other.decision)
            assert (got.merge_seconds is None) == (other.merge_seconds is None)
            assert got.served is None and other.served is None
            if not merged:
                np.testing.assert_allclose(got.losses, other.losses, rtol=1e-5, atol=1e-6)
            dev[name] = max(dev[name], _rel(got.losses, other.losses))
            spread[name] = max(spread[name], _rel(twin.losses, twins[name].losses))
        merged |= got.decision.merge
    assert paged.governor.state.merges > 0 and paged.detections_total > 0
    beta = paged.arena.beta.numpy()
    beta_dev = {"resident": np.abs(beta - resident.states.beta.numpy()).max(),
                "ref": np.abs(beta - ref.arena.beta).max()}
    beta_spread = {
        "resident": np.abs(ref_kernel.arena.beta - np.asarray(ref_kernel_resident.states.beta)).max(),
        "ref": np.abs(ref_kernel.arena.beta - ref.arena.beta).max()}
    for name in pairs:
        loss_bound = max(1e-5, 2 * spread[name])
        beta_bound = max(5e-5, 2 * beta_spread[name])
        print(f"{topology.name} paged vs {name}: losses {dev[name]:.3e} (bound {loss_bound:.3e},"
              f" the reference's spread {spread[name]:.3e}), beta {beta_dev[name]:.3e} (bound"
              f" {beta_bound:.3e}, spread {beta_spread[name]:.3e})")
        assert dev[name] <= loss_bound, (name, dev[name], spread[name])
        assert beta_dev[name] <= beta_bound, (name, beta_dev[name], beta_spread[name])
    assert paged.detections_total == resident.detections_total == ref.detections_total
    assert list(paged.detections) == list(resident.detections) == list(ref.detections)
    paged.assert_compile_once()  # the plain versions count nothing on the CPU
    assert set(paged.last_paging) >= {"in_s", "out_s", "compute_s", "span_s"}


def test_paged_runtime_served_mask_and_callable_batch(fleet):
    """Unserved devices keep their state bit for bit; a callable batch is
    dealt a cohort at a time."""
    paged = CohortFleetRuntime(_arena(fleet), _config(star(D)), cohort_size=C, device="cpu")
    p0 = paged.arena.p.clone()
    count0 = paged.det.count.clone()
    served = np.ones(D, bool)
    served[5] = served[20] = False
    batch = np.random.default_rng(0).normal(size=(D, B, F)).astype(np.float32)
    calls = []

    def batch_fn(lo, hi):
        calls.append((lo, hi))
        return batch[lo:hi]

    rep = paged.tick(batch_fn, served=served)
    assert calls == CohortSchedule(D, C).bounds()
    assert torch.equal(paged.arena.p[5], p0[5]) and torch.equal(paged.arena.p[20], p0[20])
    assert int(paged.det.count[5]) == int(count0[5])
    assert not torch.equal(paged.arena.p[6], p0[6])
    np.testing.assert_array_equal(rep.served, served)
    # a tensor batch takes the same path as the array
    other = CohortFleetRuntime(_arena(fleet), _config(star(D)), cohort_size=C, device="cpu")
    rep2 = other.tick(torch.from_numpy(batch), served=served)
    np.testing.assert_array_equal(rep.losses, rep2.losses)
    assert torch.equal(other.arena.beta, paged.arena.beta)


def test_paged_runtime_cohort_rotation(fleet):
    """With fewer active cohorts than cohorts, the inactive ones report NaN
    losses and keep their model and detector state."""
    paged = CohortFleetRuntime(_arena(fleet), _config(star(D)), cohort_size=C,
                               active_per_tick=2, device="cpu")
    p0 = paged.arena.p.clone()
    batch = np.random.default_rng(0).normal(size=(D, B, F)).astype(np.float32)
    rep = paged.tick(batch)
    assert np.isfinite(rep.losses[:16]).all() and np.isnan(rep.losses[16:]).all()
    np.testing.assert_array_equal(rep.served, np.arange(D) < 16)
    assert torch.equal(paged.arena.p[16:], p0[16:])
    assert int((paged.det.count[16:] == 0).sum()) == 16
    rep = paged.tick(batch)
    assert np.isnan(rep.losses[:16]).all() and np.isfinite(rep.losses[16:]).all()
    assert bool((paged.det.count == 1).all())


def test_paged_runtime_rotation_matches_reference(fleet, ref_fleet):
    paged = CohortFleetRuntime(_arena(fleet), _config(ring(D, 2)), cohort_size=C,
                               active_per_tick=3, device="cpu")
    ref = RefCohortRuntime(RefFleetArena.from_fleet(ref_fleet), _ref_config(ref_ring(D, 2)),
                           cohort_size=C, active_per_tick=3)
    for t, batch in enumerate(_tick_batches(TICKS, drift_dev=3, drift_from=6)):
        got, want = paged.tick(batch), ref.tick(batch)
        np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got.served, want.served)
        assert np.array_equal(got.drifted, want.drifted), t
        assert _decision(got) == _decision(want), t
    np.testing.assert_allclose(paged.arena.beta.numpy(), ref.arena.beta, atol=5e-5, rtol=0)


def test_paged_runtime_rejects_unsupported_config(fleet):
    from repro_torch.fleet import FaultInjector, RobustConfig, StalenessSchedule

    arena = _arena(fleet)
    base = dict(topology=star(D), ridge=RIDGE)
    for bad in (
        dict(staleness=StalenessSchedule.random(D, max_lag=2, seed=0)),
        dict(robust=RobustConfig()),
        dict(faults=FaultInjector(n_devices=D, specs=())),
        dict(payload_precision="int8"),
        dict(snapshot_every=4, snapshot_dir="unused"),
    ):
        with pytest.raises(ValueError):
            CohortFleetRuntime(arena, RuntimeConfig(**base, **bad), cohort_size=C, device="cpu")
    with pytest.raises(ValueError, match="cohort_size"):
        CohortFleetRuntime(arena, RuntimeConfig(**base), device="cpu")
    with pytest.raises(ValueError, match="topology"):
        CohortFleetRuntime(arena, RuntimeConfig(topology=star(2 * D), ridge=RIDGE),
                           cohort_size=C, device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        CohortFleetRuntime(arena, RuntimeConfig(**base), schedule=CohortSchedule(2 * D, C),
                           device="cpu")
    rt = CohortFleetRuntime(arena, RuntimeConfig(**base), cohort_size=C, device="cpu")
    with pytest.raises(ValueError, match="tick batch"):
        rt.tick(np.zeros((D + 1, B, F), np.float32))
    with pytest.raises(ValueError, match="B=0"):
        rt.tick(np.zeros((D, 0, F), np.float32))
    with pytest.raises(ValueError, match="cohort batch"):
        rt.tick(lambda lo, hi: np.zeros((hi - lo - 1, B, F), np.float32))
    with pytest.raises(ValueError, match="served"):
        rt.tick(np.zeros((D, B, F), np.float32), served=np.ones(D + 1, bool))


def test_paged_runtime_warmup_changes_nothing(fleet):
    paged = CohortFleetRuntime(_arena(fleet), _config(hierarchical(D, 6, head_exchange=False)),
                               cohort_size=C, device="cpu")
    det0 = paged.det
    paged.warmup(B)
    assert torch.equal(paged.arena.p, fleet.p) and torch.equal(paged.arena.beta, fleet.beta)
    assert paged.det is det0 and paged.tick_no == 0 and paged.governor.state.ticks == 0


def test_paged_runtime_telemetry_gauges(fleet, tmp_path):
    from repro_torch.obs import TelemetryConfig

    paged = CohortFleetRuntime(_arena(fleet), _config(star(D), telemetry=TelemetryConfig(
        dir=tmp_path)), cohort_size=C, device="cpu")
    for batch in _tick_batches(3):
        paged.tick(batch)
    tel = paged.telemetry
    assert tel.ticks.value == 3
    assert tel.cohort_pages.value == 3 * (D // C)
    assert tel.arena_bytes.value == paged.arena.nbytes
    assert tel.arena_resident_devices.value == D
    assert tel.merge_rounds.value == paged.merge_round > 0
    tiers = {k: c.value for k, c in tel.merge_tier_bytes.children.items()}
    assert tiers.get(("intra",), 0) > tiers.get(("inter",), 0) > 0
    phases = {k: c for k, c in tel.phase_seconds.children.items()}
    assert all(phases[(p,)].count == 3 for p in ("page_in", "page_out", "ingest", "govern"))
    summary = paged.finalize_telemetry()
    assert summary["ticks"] == 3
