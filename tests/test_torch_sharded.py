"""The port's sharded fleet across four gloo ranks on the CPU, against the
reference's single-process fleet, as the reference's own sharded scripts
hold it (``tests/test_distribution.py``: D = 32, F = 24, Ñ = 8, ridge
1e-3); those scripts fail on this jax, so the port is held to the
reference's single-process ``fleet_train`` and ``fleet_merge``.

The four ranks are spawned once (``repro_torch.launch.mesh.spawn``) and run
every check in one group (``tests/torch_mesh_ranks.py::sharded_checks``):

- ``fleet_train_sharded`` (each rank its block of 8, no collective)
  against the reference's ``fleet_train`` at the reference's 1e-4 and the
  port's single-process ``fleet_train`` bit for bit;
- ``fleet_merge_sharded`` on all_to_all, star, hierarchical (C = 4) and
  isolated hierarchical, one all-reduce of the (clusters, Ñ, Ñ+m) partials,
  against the reference's ``fleet_merge`` at its 1e-4, with every rank's
  merged model equal bit for bit where the topology merges to one model,
  and the bytes each rank sent O(clusters);
- the open ring's halo at hops 1, 2 and 8 (a whole shard) against the
  reference's ``fleet_merge`` at 1e-4 and the port's single-process banded
  merge bit for bit (each window summed in the same order), and hops 9
  refused naming the halo;
- ``cohort_tree_reduce`` over the mesh against an f64 sum, and refusing 7
  cohorts over 4 shards; ``CohortMerger(mesh=)`` in global mode on an arena
  of 32 devices in 4 cohorts of 8, one a rank, against ``mesh=None`` at
  twice the spread between the flat merge and the paged one.
"""
import jax
import numpy as np
import pytest
import torch

from repro.fleet import (
    all_to_all as ref_all_to_all,
    fleet_merge as ref_fleet_merge,
    fleet_train as ref_fleet_train,
    hierarchical as ref_hierarchical,
    init_fleet as ref_init_fleet,
    ring as ref_ring,
    star as ref_star,
)
from repro_torch.fleet import fleet_merge, fleet_train, ring, star
from repro_torch.launch.mesh import spawn

import torch_mesh_ranks

torch.set_num_threads(2)

D, H, F, T, RIDGE, SHARDS = 32, 8, 24, 16, 1e-3, 4
TOPOLOGIES = {"all_to_all": (), "star": (), "hierarchical": (4,), "hierarchical_isolated": (4,)}
REF_TOPOLOGIES = {"all_to_all": ref_all_to_all, "star": ref_star,
                  "hierarchical": lambda d: ref_hierarchical(d, 4),
                  "hierarchical_isolated": lambda d: ref_hierarchical(d, 4, head_exchange=False)}
HOPS = (1, 2, 8)


def _leaves(fleet) -> dict:
    return {"alpha": np.asarray(fleet.params.alpha), "bias": np.asarray(fleet.params.bias),
            "beta": np.asarray(fleet.beta), "p": np.asarray(fleet.p),
            "activation": fleet.activation, "forget": fleet.forget}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    key = jax.random.PRNGKey(0)
    x_init = jax.random.uniform(key, (D, 2 * H, F))
    fleet = ref_init_fleet(key, D, F, H, x_init, activation="identity", ridge=RIDGE)
    streams = np.array(jax.random.uniform(jax.random.PRNGKey(1), (D, T, F)))
    trained = ref_fleet_train(fleet, streams)
    rng = np.random.default_rng(0)
    cohort = {"size": D // SHARDS, "mask": rng.random(D) < 0.8,
              "partials": rng.standard_normal((8, 3, 5)).astype(np.float32)}
    results = spawn(torch_mesh_ranks.sharded_checks, SHARDS, tmp_path_factory.mktemp("rdv"),
                    device="cpu", timeout=120,
                    args=(_leaves(fleet), streams, _leaves(trained), TOPOLOGIES, HOPS, RIDGE,
                          cohort))
    return {"fleet": fleet, "streams": streams, "trained": trained, "cohort": cohort,
            "ranks": results}


def _stacked(ranks, *path):
    """The ranks' blocks of one result, in shard order, as one fleet."""
    blocks = sorted(ranks, key=lambda r: r["index"])
    out = {}
    for leaf in ("beta", "p"):
        parts = []
        for r in blocks:
            x = r
            for k in path:
                x = x[k]
            parts.append(x[leaf])
        out[leaf] = np.concatenate(parts)
    return out


def _port(leaves):
    return torch_mesh_ranks._state(leaves)


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def test_sharded_training_matches_both_packages(case):
    got = _stacked(case["ranks"], "trained")
    ref = case["trained"]
    err = _max_abs(got["beta"], ref.beta)
    print(f"fleet_train_sharded against the reference's fleet_train: beta {err:.3e}")
    assert err < 1e-4 and _max_abs(got["p"], ref.p) < 1e-4
    port = fleet_train(_port(_leaves(case["fleet"])), torch.from_numpy(case["streams"]))
    assert np.array_equal(got["beta"], port.beta.numpy())
    assert np.array_equal(got["p"], port.p.numpy())


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_psum_merge_matches_reference(case, name):
    got = _stacked(case["ranks"], "merged", name)
    ref = ref_fleet_merge(case["trained"], REF_TOPOLOGIES[name](D), ridge=RIDGE)
    err = _max_abs(got["beta"], ref.beta)
    print(f"{name}: fleet_merge_sharded against the reference's fleet_merge: beta {err:.3e}")
    assert err < 1e-4 and _max_abs(got["p"], ref.p) < 1e-4
    if name != "hierarchical_isolated":  # one merged model, on every rank alike
        for leaf in ("beta", "p"):
            assert all(np.array_equal(got[leaf][0], row) for row in got[leaf])
    n_clusters = 4 if name == "hierarchical_isolated" or name == "hierarchical" else 1
    payload = n_clusters * H * (H + F) * 4
    for r in case["ranks"]:  # one all-reduce of the partials, never the devices
        assert r["merged"][name]["wire_bytes"] == payload


@pytest.mark.parametrize("hops", HOPS)
def test_halo_merge_matches_reference(case, hops):
    got = _stacked(case["ranks"], "halo", hops)
    ref = ref_fleet_merge(case["trained"], ref_ring(D, hops), ridge=RIDGE)
    err = _max_abs(got["beta"], ref.beta)
    print(f"ring hops={hops}: the halo merge against the reference's fleet_merge: beta {err:.3e}")
    assert err < 1e-4 and _max_abs(got["p"], ref.p) < 1e-4
    port = fleet_merge(_port(_leaves(case["trained"])), ring(D, hops), ridge=RIDGE)
    assert np.array_equal(got["beta"], port.beta.numpy())
    assert np.array_equal(got["p"], port.p.numpy())
    for r in case["ranks"]:  # hops payloads each way
        assert r["halo"][hops]["wire_bytes"] == 2 * hops * H * (H + F) * 4


def test_halo_wider_than_a_shard_raises(case):
    for r in case["ranks"]:
        assert "halo exchange needs hops=9" in r["halo_error"]


def test_cohort_tree_reduce_over_the_mesh(case):
    want = case["cohort"]["partials"].astype(np.float64).sum(0)
    for r in case["ranks"]:
        assert np.array_equal(r["tree"], case["ranks"][0]["tree"])
        np.testing.assert_allclose(r["tree"], want, rtol=1e-6, atol=1e-6)
        assert "not divisible by 4 mesh shards" in r["tree_error"]


def test_cohort_merger_over_the_mesh(case):
    mask = case["cohort"]["mask"]
    flat_mask = torch.from_numpy(mask.astype(np.float32))
    from repro_torch.fleet import fleet_merge_masked_kernel

    flat = fleet_merge_masked_kernel(_port(_leaves(case["trained"])), star(D), flat_mask,
                                      ridge=RIDGE)
    first = case["ranks"][0]["cohort"]
    spread = _max_abs(first[False]["beta"], flat.beta.numpy())
    for r in case["ranks"]:
        got, want = r["cohort"][True], r["cohort"][False]
        assert np.array_equal(got["beta"], first[True]["beta"])  # the same on every rank
        assert np.array_equal(got["p"], first[True]["p"])
        err = _max_abs(got["beta"], want["beta"])
        assert err <= 2 * spread, (err, spread)
        # the rows of devices outside the mask are untouched
        assert np.array_equal(got["beta"][~mask], np.asarray(case["trained"].beta)[~mask])
        assert got["launches"] == {"masked_segment_sum_mix": 1, "from_uv_solve": 1}
        assert want["launches"] == {"masked_segment_sum_mix": 4, "from_uv_solve": 1}
    print(f"CohortMerger over the mesh against mesh=None: beta {err:.3e}; the paged merge "
          f"against the flat one {spread:.3e}")
