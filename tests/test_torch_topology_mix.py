"""The port's unmasked mix kernels and ``topology_mix`` against the
reference on the CPU.

- The plain versions of ``segment_sum_mix``, ``segment_broadcast`` and
  ``banded_mix`` (what the wrappers run for CPU tensors) against the
  reference's Pallas kernels in interpret mode, bit for bit: both sum from
  zero, cluster members in ascending device order and ring neighbours from
  −hops to +hops. Ragged clusters at D = 13, odd rows and columns; hops 1,
  2 and 6 (2·hops+1 = D, the widest band the kernel takes). Both packages
  refuse a wider band and unsorted cluster ids.
- ``topology_mix`` and ``Topology.mix`` against the reference's
  ``topology_mix`` (interpret mode) and ``Topology.mix`` on every kind of
  topology, at 1e-6 relative to the largest output: the reference's
  ``Topology.mix`` rolls the ring in the other order and its closed band
  and head exchange sum with XLA's reduction, so they agree to f32
  rounding, not to the bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet import (
    all_to_all as ref_all_to_all,
    hierarchical as ref_hierarchical,
    ring as ref_ring,
    star as ref_star,
)
from repro.fleet.topology import Topology as RefTopology
from repro.kernels.topology_merge import (
    banded_mix as ref_banded_mix,
    segment_broadcast as ref_segment_broadcast,
    segment_sum_mix as ref_segment_sum_mix,
    topology_mix as ref_topology_mix,
)
from repro_torch.fleet import Topology, all_to_all, hierarchical, ring, star
from repro_torch.kernels import (
    banded_mix,
    banded_mix_plain,
    segment_broadcast,
    segment_broadcast_plain,
    segment_sum_mix,
    segment_sum_mix_plain,
    topology_mix,
)

torch.set_num_threads(2)

D_ODD, R_ODD, C_ODD = 13, 10, 37
# ragged clusters: 4, 1, 6 and 2 members
CIDS = np.array([0] * 4 + [1] + [2] * 6 + [3] * 2, np.int32)


def _x(seed, shape=(D_ODD, R_ODD, C_ODD)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _custom_mask(d, seed=9):
    m = (np.random.default_rng(seed).random((d, d)) < 0.35).astype(np.float32)
    return np.maximum(np.maximum(m, m.T), np.eye(d, dtype=np.float32))


@pytest.mark.parametrize("n_clusters,cids", [(4, CIDS), (1, np.zeros(D_ODD, np.int32))])
def test_segment_sum_plain_is_the_pallas_kernel_bit_for_bit(n_clusters, cids):
    x = _x(1)
    want = np.asarray(ref_segment_sum_mix(jnp.asarray(x), cids, n_clusters, interpret=True))
    got = segment_sum_mix_plain(torch.from_numpy(x), cids, n_clusters)
    np.testing.assert_array_equal(got.numpy(), want)
    # the CPU wrapper is the plain version
    assert torch.equal(segment_sum_mix(torch.from_numpy(x), cids, n_clusters), got)


def test_segment_sum_refuses_unsorted_ids_as_the_reference_does():
    x = _x(2)
    shuffled = CIDS[::-1].copy()
    with pytest.raises(ValueError, match="sorted"):
        ref_segment_sum_mix(jnp.asarray(x), shuffled, 4, interpret=True)
    with pytest.raises(ValueError, match="sorted"):
        segment_sum_mix(torch.from_numpy(x), shuffled, 4)
    with pytest.raises(ValueError, match=r"\[0, 3\)"):
        segment_sum_mix(torch.from_numpy(x), CIDS, 3)


def test_segment_broadcast_plain_is_the_pallas_kernel_bit_for_bit():
    sums = _x(3, (4, R_ODD, C_ODD))
    want = np.asarray(ref_segment_broadcast(jnp.asarray(sums), jnp.asarray(CIDS),
                                            interpret=True))
    got = segment_broadcast_plain(torch.from_numpy(sums), CIDS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(segment_broadcast(torch.from_numpy(sums), CIDS), got)
    with pytest.raises(ValueError, match=r"\[0, 3\)"):
        segment_broadcast(torch.from_numpy(sums[:3]), CIDS)


@pytest.mark.parametrize("hops", [1, 2, 6])
def test_banded_mix_plain_is_the_pallas_kernel_bit_for_bit(hops):
    x = _x(4 + hops)
    want = np.asarray(ref_banded_mix(jnp.asarray(x), hops, interpret=True))
    got = banded_mix_plain(torch.from_numpy(x), hops)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(banded_mix(torch.from_numpy(x), hops), got)


def test_banded_mix_refuses_a_band_wider_than_the_ring():
    x = _x(11)
    with pytest.raises(ValueError, match="band"):
        ref_banded_mix(jnp.asarray(x), 7, interpret=True)
    with pytest.raises(ValueError, match="band"):
        banded_mix(torch.from_numpy(x), 7)


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
    "ring_closed": (lambda d: ring(d, 7), lambda d: ref_ring(d, 7)),
    "custom_dense": (
        lambda d: Topology(name="custom", n_devices=d, kind="dense", matrix=_custom_mask(d)),
        lambda d: RefTopology(name="custom", n_devices=d, kind="dense", matrix=_custom_mask(d)),
    ),
}


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_topology_mix_matches_reference(topo_name):
    port_fn, ref_fn = TOPOS[topo_name]
    topo, ref_topo = port_fn(D_ODD), ref_fn(D_ODD)
    x = _x(12)
    kernel = np.asarray(ref_topology_mix(jnp.asarray(x), ref_topo, interpret=True))
    plain = np.asarray(ref_topo.mix(jnp.asarray(x)))
    got = topology_mix(torch.from_numpy(x), topo)
    assert got.shape == x.shape
    for want in (kernel, plain):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)
    assert torch.equal(topo.mix(torch.from_numpy(x)), got)
    # each device's sum over its neighbour set, exactly as the mask says
    np.testing.assert_allclose(
        got.numpy(), np.einsum("ij,j...->i...", topo.dense_matrix(), x).astype(np.float32),
        rtol=0, atol=1e-6 * np.abs(kernel).max())
