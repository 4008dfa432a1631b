"""Byzantine-robust segment sum, the clipped and trimmed variant of
``masked_segment_sum_mix``; port of ``repro.kernels.robust_merge``.

- ``robust_segment_sum_mix`` — per cluster c, over its contiguous run of
  devices: v = x[d]·scale[d] (the clip factor, rounded once), tot[c] =
  Σ v·mask[d], and per coordinate the ``trim`` smallest and ``trim``
  largest participating values in online insertion chains (each register
  does cur = r; r = min(cur, v); v = max(cur, v), with ±inf sentinels for
  masked devices). lo and hi are the registers summed in register order,
  an unfilled (non-finite) register taken as 0. An empty cluster is
  written as zeros.
- ``robust_segment_combine`` — the trimmed-mean estimate of each
  segment sum from those three outputs (plain PyTorch).

The wrapper takes ``robust_segment_sum_mix_plain`` for CPU tensors and
launches the kernel of ``csrc/robust_merge.cu`` for CUDA tensors, or
raises. The plain version inserts and adds in ascending device order
(not the sort-based oracle of the reference), and the kernel agrees with
it bit for bit at any ``trim`` ≥ 0:

- tot keeps that order on the card: one chain of adds from +0 in device
  order, each product rounded apart;
- lo and hi are free of it: a chain's registers end holding the sorted
  ``trim`` extremes of its live values whatever the order they came in (a
  NaN fills every register, which sums as 0; a tie of −0 and +0 moves
  only a zero's sign, which a sum from +0 does not show). So the card may
  split a cluster's devices among several chains and merge them.

``robust_streamed`` picks the kernel's plan from the shape, the trim and
the card's SMs (one launch count a call either way).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.topology_merge import (
    SEG_SLICE,
    _device_starts,
    _segment_starts,
    _sm_count,
)

__all__ = [
    "robust_segment_combine",
    "robust_segment_sum_mix",
    "robust_segment_sum_mix_plain",
    "robust_streamed",
]

# The kernel's two launch plans (csrc/robust_merge.cu): one thread an
# element and a cluster, walking the cluster's devices itself; or blocks of
# 32 elements of a cluster that stream its rows through shared memory,
# split them among nine warps' chains and add tot in device order on one
# more. Both give the plain version's bits.
ROBUST_REG_TRIM = 8  # the longest chains in registers, the streamed plan's limit
# rows of the longest cluster a streamed block must get for each wave of
# blocks, by trim: past trim 6 the per-element plan's chains gain on the
# streamed plan's sorters
ROBUST_ROWS_A_WAVE = (40, 40, 40, 40, 40, 40, 40, 48, 128)


def robust_streamed(n_clusters: int, elems: int, longest: int, trim: int, sms: int) -> bool:
    """Whether ``robust_segment_sum_mix`` over ``n_clusters`` clusters of
    ``elems`` elements, the longest of ``longest`` devices, at ``trim``
    takes the streamed plan on a card of ``sms`` SMs. That plan runs one
    block an SM (its ring and the chains' merge take 136-154 KB), one for
    each 32-element slice of
    each cluster, and takes trims up to ``ROBUST_REG_TRIM``: it wins where
    the longest cluster gives a block more than ``ROBUST_ROWS_A_WAVE[trim]``
    rows for each wave of blocks. Set from both plans timed on an H100 at
    149 shapes, trims 0-8 (PERF.md §6): the star of 4096 devices on (32, 80)
    payloads streams (19× faster at trim 1), the har width and many short
    clusters take the per-element plan (2-26× faster)."""
    if trim > ROBUST_REG_TRIM:
        return False
    waves = -(-(-(-elems // SEG_SLICE) * n_clusters) // sms)
    return longest > ROBUST_ROWS_A_WAVE[trim] * waves


def _check(x: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor, trim: int) -> None:
    if x.ndim != 3:
        raise ValueError(f"need x (D, R, C); got {tuple(x.shape)}")
    d = x.shape[0]
    if tuple(mask.shape) != (d,) or tuple(scale.shape) != (d,):
        raise ValueError(f"mask and scale must be ({d},); got {tuple(mask.shape)}, "
                         f"{tuple(scale.shape)}")
    if trim < 0:
        raise ValueError(f"need trim >= 0, got {trim}")


def robust_segment_sum_mix_plain(
    x: torch.Tensor, cluster_ids, mask: torch.Tensor, scale: torch.Tensor,
    n_clusters: int, trim: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check(x, mask, scale, trim)
    starts = _segment_starts(cluster_ids, x.shape[0], n_clusters, "robust_segment_sum_mix")
    mf = mask.to(torch.float32)
    sc = scale.to(torch.float32)
    shape = (n_clusters,) + tuple(x.shape[1:])
    tot = torch.zeros(shape, dtype=torch.float32, device=x.device)
    lo = torch.zeros_like(tot)
    hi = torch.zeros_like(tot)
    inf = torch.tensor(float("inf"), device=x.device)
    for c in range(n_clusters):
        acc = torch.zeros(shape[1:], dtype=torch.float32, device=x.device)
        mins = [inf.expand(shape[1:])] * trim
        maxs = [-inf.expand(shape[1:])] * trim
        for d in range(int(starts[c]), int(starts[c + 1])):
            v = x[d].to(torch.float32) * sc[d]
            acc = acc + v * mf[d]
            live = mf[d] > 0
            lo_v = torch.where(live, v, inf)
            for k in range(trim):
                cur = mins[k]
                mins[k] = torch.minimum(cur, lo_v)
                lo_v = torch.maximum(cur, lo_v)
            hi_v = torch.where(live, v, -inf)
            for k in range(trim):
                cur = maxs[k]
                maxs[k] = torch.maximum(cur, hi_v)
                hi_v = torch.minimum(cur, hi_v)
        tot[c] = acc
        for k in range(trim):
            lo[c] = lo[c] + torch.where(torch.isfinite(mins[k]), mins[k], 0.0)
            hi[c] = hi[c] + torch.where(torch.isfinite(maxs[k]), maxs[k], 0.0)
    return tot, lo, hi


def robust_segment_sum_mix(
    x: torch.Tensor, cluster_ids, mask: torch.Tensor, scale: torch.Tensor,
    n_clusters: int, trim: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clipped, trimmed, participation-masked cluster aggregates of x
    (D, R, C): ``(tot, lo, hi)``, each (n_clusters, R, C). ``cluster_ids``
    must be sorted (each cluster one contiguous run of devices)."""
    _check(x, mask, scale, trim)
    if x.device.type == "cpu":
        return robust_segment_sum_mix_plain(x, cluster_ids, mask, scale, n_clusters, trim)
    x, mask, scale = _lib.operands("robust_segment_sum_mix", x=x, mask=mask.to(torch.float32),
                                   scale=scale.to(torch.float32))
    starts, longest = _device_starts(cluster_ids, x.shape[0], n_clusters,
                                     "robust_segment_sum_mix", x.device)
    shape = (n_clusters,) + tuple(x.shape[1:])
    tot, lo, hi = (torch.empty(shape, dtype=torch.float32, device=x.device) for _ in range(3))
    elems = x[0].numel() if x.shape[0] else 0
    streamed = int(robust_streamed(n_clusters, elems, longest, trim, _sm_count(x.device)))
    lib = _lib.library()
    # chains too long for one block's shared memory live in a workspace
    ws = _lib.workspace(lib.repro_robust_ws(trim, n_clusters, elems), x.device)
    status = lib.repro_robust_segment_sum(
        x.data_ptr(), starts.data_ptr(), mask.data_ptr(), scale.data_ptr(),
        tot.data_ptr(), lo.data_ptr(), hi.data_ptr(), n_clusters, elems, trim,
        _lib.ptr(ws), streamed, _lib.stream(),
    )
    _lib.check(status, "robust_segment_sum_mix")
    _lib.count_launch("robust_segment_sum_mix")
    return tot, lo, hi


def robust_segment_combine(
    tot: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, counts: torch.Tensor, trim: int
) -> torch.Tensor:
    """Coordinate-wise trimmed-mean estimate of each segment sum,
    (tot − lo − hi) / (count − 2·trim) · count, so ``trim=0`` is the plain
    masked sum. A segment with at most 2·trim participants cannot be
    trimmed and keeps its plain sum."""
    if trim == 0:
        return tot
    counts = counts.to(torch.float32).reshape(-1, 1, 1)
    live = counts - 2.0 * trim
    trimmed = (tot - lo - hi) / torch.clamp(live, min=1.0) * counts
    return torch.where(live >= 1.0, trimmed, tot)
