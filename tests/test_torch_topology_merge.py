"""The port's masked merge against the reference on the CPU.

- The three plain merge kernels (what the wrappers run for CPU tensors)
  against the reference's Pallas kernels in interpret mode, at 1e-5.
- ``fleet_merge_masked_kernel``, the port's one merge, on the plain
  versions of its kernels, against the reference's ``fleet_merge_masked``
  (the XLA Cholesky form) on every topology the runtime routes, at
  D = 13 with random masks, one of which empties a whole cluster, and
  with the all-ones mask against the reference's unmasked
  ``fleet_merge``. P is held at 1e-5; β at atol 5e-5, because the
  reference's own Gauss-Jordan and Cholesky solves differ by up to
  1.8e-5 on β at this conditioning (ROADMAP queue 3).
- Non-participants keep their state bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet import (
    all_to_all as ref_all_to_all,
    fleet_merge as ref_fleet_merge,
    fleet_merge_masked as ref_fleet_merge_masked,
    fleet_train as ref_fleet_train,
    hierarchical as ref_hierarchical,
    init_fleet as ref_init_fleet,
    ring as ref_ring,
    star as ref_star,
)
from repro.kernels.topology_merge import (
    banded_merge_solve as ref_banded_merge_solve,
    from_uv_solve as ref_from_uv_solve,
    masked_segment_sum_mix as ref_masked_segment_sum_mix,
)
from repro_torch.convert import oselm_state_from_numpy
from repro_torch.core import UV
from repro_torch.fleet import (
    Topology,
    all_to_all,
    fleet_from_uv,
    fleet_merge_masked_kernel,
    fleet_to_uv,
    hierarchical,
    ring,
    star,
)
from repro_torch.kernels import (
    banded_merge_solve_plain,
    from_uv_solve_plain,
    masked_segment_sum_mix_plain,
)

torch.set_num_threads(2)

D_ODD, R_ODD, C_ODD = 13, 10, 37
RIDGE = 1e-3

TOPOS = {
    "star": (star, ref_star),
    "hierarchical": (lambda d: hierarchical(d, 3), lambda d: ref_hierarchical(d, 3)),
    "hierarchical_isolated": (
        lambda d: hierarchical(d, 3, head_exchange=False),
        lambda d: ref_hierarchical(d, 3, head_exchange=False),
    ),
    "all_to_all": (all_to_all, ref_all_to_all),
    "ring1": (lambda d: ring(d, 1), lambda d: ref_ring(d, 1)),
    "ring2": (lambda d: ring(d, 2), lambda d: ref_ring(d, 2)),
}

# cluster ids of hierarchical(13, 3): [0]*5 + [1]*4 + [2]*4; the last mask
# drops every member of cluster 1
MASKS = {
    "all": np.ones(D_ODD, np.float32),
    "random": (np.random.default_rng(0).random(D_ODD) < 0.7).astype(np.float32),
    "cluster1_out": np.array([1] * 5 + [0] * 4 + [1, 0, 1, 1], np.float32),
}


def _spd(rng, s, n):
    a = rng.standard_normal((s, n, 3 * n)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) / (3 * n)).astype(np.float32)


def test_masked_segment_sum_plain_matches_interpret():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((D_ODD, R_ODD, C_ODD)).astype(np.float32)
    cids = np.array([0] * 4 + [2] * 6 + [3] * 3, np.int32)  # cluster 1 empty
    mask = MASKS["random"]
    ref = ref_masked_segment_sum_mix(jnp.asarray(w), cids, jnp.asarray(mask), 4, interpret=True)
    got = masked_segment_sum_mix_plain(torch.from_numpy(w), cids, torch.from_numpy(mask), 4)
    # the reference never writes the block of a cluster without members
    # (it reads as NaN in interpret mode); the port writes zeros there
    live = [0, 2, 3]
    np.testing.assert_allclose(got.numpy()[live], np.asarray(ref)[live], rtol=1e-5, atol=1e-5)
    assert not got[1].any()
    with pytest.raises(ValueError, match="sorted"):
        masked_segment_sum_mix_plain(torch.from_numpy(w), cids[::-1].copy(),
                                     torch.from_numpy(mask), 4)


@pytest.mark.parametrize("s", [1, 3])
def test_from_uv_solve_plain_matches_interpret(s):
    rng = np.random.default_rng(2)
    u = _spd(rng, s, R_ODD)
    v = rng.standard_normal((s, R_ODD, 23)).astype(np.float32)
    ref_p, ref_b = ref_from_uv_solve(jnp.asarray(u), jnp.asarray(v), ridge=RIDGE, interpret=True)
    p, b = from_uv_solve_plain(torch.from_numpy(u), torch.from_numpy(v), ridge=RIDGE)
    np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(ref_b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hops", [1, 2])
def test_banded_merge_solve_plain_matches_interpret(hops):
    rng = np.random.default_rng(3 + hops)
    u = _spd(rng, D_ODD, R_ODD)
    v = rng.standard_normal((D_ODD, R_ODD, 23)).astype(np.float32)
    w = np.concatenate([u, v], axis=2) * MASKS["random"][:, None, None]
    ref_p, ref_b = ref_banded_merge_solve(jnp.asarray(w), hops, ridge=RIDGE, interpret=True)
    p, b = banded_merge_solve_plain(torch.from_numpy(w), hops, ridge=RIDGE)
    np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(ref_b), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="band"):
        banded_merge_solve_plain(torch.from_numpy(w[:4]), 2, ridge=RIDGE)


@pytest.fixture(scope="module")
def trained_fleet():
    rng = np.random.default_rng(4)
    feat, hid = 24, 8
    x_init = rng.uniform(0, 1, (D_ODD, 2 * hid, feat)).astype(np.float32)
    fleet = ref_init_fleet(jax.random.PRNGKey(0), D_ODD, feat, hid, jnp.asarray(x_init),
                           activation="identity", ridge=RIDGE)
    streams = rng.uniform(0, 1, (D_ODD, 16, feat)).astype(np.float32)
    return ref_fleet_train(fleet, jnp.asarray(streams))


def _port(fleet):
    return oselm_state_from_numpy(
        fleet.params.alpha, fleet.params.bias, fleet.beta, fleet.p,
        activation=fleet.activation, forget=fleet.forget, device="cpu",
    )


@pytest.mark.parametrize("mask_name", sorted(MASKS))
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_masked_merge_matches_reference(trained_fleet, topo_name, mask_name):
    port_fn, ref_fn = TOPOS[topo_name]
    mask = MASKS[mask_name]
    ref = ref_fleet_merge_masked(trained_fleet, ref_fn(D_ODD), jnp.asarray(mask), ridge=RIDGE)
    before = _port(trained_fleet)
    got = fleet_merge_masked_kernel(before, port_fn(D_ODD), torch.from_numpy(mask), ridge=RIDGE)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(ref.beta), rtol=1e-5, atol=5e-5)
    out = mask == 0
    assert torch.equal(got.p[out], before.p[out])
    assert torch.equal(got.beta[out], before.beta[out])


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_all_ones_mask_is_the_unmasked_merge(trained_fleet, topo_name):
    """With every device taking part, the masked merge is the reference's
    unmasked ``fleet_merge``."""
    port_fn, ref_fn = TOPOS[topo_name]
    ref = ref_fleet_merge(trained_fleet, ref_fn(D_ODD), ridge=RIDGE)
    got = fleet_merge_masked_kernel(_port(trained_fleet), port_fn(D_ODD), torch.ones(D_ODD),
                                    ridge=RIDGE)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(ref.beta), rtol=1e-5, atol=5e-5)


def test_dense_partial_mask_needs_dense_mix(trained_fleet):
    m = np.eye(D_ODD, dtype=np.float32)
    topo = Topology(name="custom", n_devices=D_ODD, kind="dense", matrix=m)
    with pytest.raises(NotImplementedError, match="dense_mix"):
        fleet_merge_masked_kernel(_port(trained_fleet), topo, torch.ones(D_ODD), ridge=RIDGE)


def test_fleet_from_uv_nonfinite_guards(trained_fleet):
    fleet = _port(trained_fleet)
    uv = fleet_to_uv(fleet, ridge=RIDGE)
    u = uv.u.clone()
    u[3, 0, 0] = float("nan")
    with pytest.raises(ValueError, match=r"devices \[3\]"):
        fleet_from_uv(fleet, UV(u=u, v=uv.v), ridge=RIDGE)
    fixed = fleet_from_uv(fleet, UV(u=u, v=uv.v), ridge=RIDGE, nonfinite="repair")
    assert torch.isfinite(fixed.p).all()
    np.testing.assert_allclose(fixed.beta[3].numpy(), 0.0)
    with pytest.raises(ValueError, match="nonfinite"):
        fleet_from_uv(fleet, uv, nonfinite="ignore")


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_topology_and_round_cost_match_reference(topo_name):
    from repro.fleet.comm import topology_round_cost as ref_cost
    from repro_torch.fleet import topology_round_cost

    port_fn, ref_fn = TOPOS[topo_name]
    for d in (D_ODD, 64):
        got, want = port_fn(d), ref_fn(d)
        assert got.name == want.name and got.is_fully_connected == want.is_fully_connected
        assert got.band_closed == want.band_closed
        np.testing.assert_array_equal(got.dense_matrix(), want.dense_matrix())
        a, b = topology_round_cost(got, 128, 561), ref_cost(want, 128, 561)
        assert (a.topology, a.n_devices, a.payloads, a.bytes_total) == (
            b.topology, b.n_devices, b.payloads, b.bytes_total)


def test_fleet_score_matches_reference(trained_fleet):
    from repro.fleet import fleet_score as ref_fleet_score
    from repro_torch.fleet import fleet_score

    x = np.random.default_rng(8).uniform(0, 1, (7, 24)).astype(np.float32)
    want = ref_fleet_score(trained_fleet, jnp.asarray(x))
    got = fleet_score(_port(trained_fleet), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
