"""The segment sums on a long single cluster, and the choice of their
launch plan, on the CPU.

- The plain versions of ``segment_sum_mix`` and ``masked_segment_sum_mix``
  (what the wrappers run for CPU tensors, and what the card is held to bit
  for bit) against the reference's Pallas kernels in interpret mode on one
  cluster of 300 devices, the star's shape at a small size, and on three
  uneven clusters: bit for bit, since both add each device's payload from
  zero in ascending device order (the mask is 0/1, so its products are
  exact however they are rounded).
- ``segsum_streamed``, which picks the kernel's plan from the shape and the
  card's SMs: the streamed plan where the longest cluster gives each of
  its blocks more than 64 rows for each wave of them, the per-element
  plan at the har width and wherever clusters are short.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topology_merge import (
    masked_segment_sum_mix as ref_masked_segment_sum_mix,
    segment_sum_mix as ref_segment_sum_mix,
)
from repro_torch.kernels import masked_segment_sum_mix_plain, segment_sum_mix_plain
from repro_torch.kernels.topology_merge import segsum_streamed

torch.set_num_threads(2)

D_LONG, R, C = 300, 3, 5
CLUSTERINGS = {
    "star": (1, np.zeros(D_LONG, np.int32)),
    "uneven": (3, np.repeat(np.arange(3, dtype=np.int32), [211, 1, 88])),
}


def _w(seed):
    return np.random.default_rng(seed).standard_normal((D_LONG, R, C)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CLUSTERINGS))
def test_segment_sum_plain_is_the_pallas_kernel_on_long_clusters(name):
    n_clusters, cids = CLUSTERINGS[name]
    w = _w(1)
    want = np.asarray(ref_segment_sum_mix(jnp.asarray(w), cids, n_clusters, interpret=True))
    got = segment_sum_mix_plain(torch.from_numpy(w), cids, n_clusters)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(CLUSTERINGS))
def test_masked_segment_sum_plain_is_the_pallas_kernel_on_long_clusters(name):
    n_clusters, cids = CLUSTERINGS[name]
    w = _w(2)
    mask = (np.random.default_rng(3).random(D_LONG) < 0.8).astype(np.float32)
    assert (mask == 0).any()
    want = np.asarray(ref_masked_segment_sum_mix(
        jnp.asarray(w), cids, jnp.asarray(mask), n_clusters, interpret=True))
    got = masked_segment_sum_mix_plain(torch.from_numpy(w), cids, torch.from_numpy(mask),
                                       n_clusters)
    np.testing.assert_array_equal(got.numpy(), want)


H100_SMS = 132  # an H100 SXM's

# (clusters, elements, longest cluster) → streamed on an H100? Both plans
# timed there on each side (PERF.md §6)
PLANS = [
    ((1, 32 * 80, 4096), True),        # the merge bench's star at D = 4096
    ((1, 32 * 80, 1024), True),        # ... and at D = 1024
    ((3, 32 * 80 - 1, 3071), True),    # three uneven clusters, 240 blocks: 2 waves
    ((4, 32 * 80, 1024), True),        # four clusters of 1024: 3 waves
    ((1, 1, 4096), True),              # one element
    ((1, 128 * 689, 256), False),      # the har width's star: 21 waves of 16 rows
    ((32, 128 * 689, 8), False),       # its hierarchy
    ((512, 32 * 80, 8), False),        # D = 4096 in clusters of 8
    ((1, 32 * 80, 64), False),         # a star of 64 devices: 64 rows, one wave...
    ((1, 32 * 80, 65), True),          # ... and of 65
    ((13, 32 * 80, 512), False),       # 13 clusters of 512: 8 waves of 64 rows...
    ((13, 32 * 80, 513), True),        # ... and of 513
    ((1, 128 * 495, 1024), True),      # a star of 1024 in 15 waves...
    ((1, 128 * 496, 1024), False),     # ... and in 16
]


@pytest.mark.parametrize("shape,streamed", PLANS)
def test_segsum_plan_follows_the_shape(shape, streamed):
    assert segsum_streamed(*shape, H100_SMS) is streamed


# the rule reads the card's SMs: 13 clusters of 513 devices on (32, 80)
# payloads are 1040 streamed blocks, 8 waves on an H100's 132 SMs but 10
# on an H100 PCIe's 114
@pytest.mark.parametrize("sms,streamed", [(132, True), (130, True), (129, False), (114, False)])
def test_segsum_plan_follows_the_card_s_sm_count(sms, streamed):
    assert segsum_streamed(13, 32 * 80, 513, sms) is streamed
