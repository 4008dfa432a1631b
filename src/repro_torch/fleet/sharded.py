"""Sharded fleet training and merges across processes; port of
``repro.fleet.sharded`` on ``torch.distributed``.

The reference shards the stacked device axis of one fleet over mesh
devices under ``shard_map``; here each rank of a ``Mesh``
(``repro_torch.launch.mesh``) holds its contiguous block of L devices
(``repro_torch.launch.sharding.shard_fleet``: device d lives on shard
d // L), and both halves of a federation round run on that block:

- ``fleet_train_sharded`` — per-tick ingest is independent across
  devices, so each rank trains its own block through the fused
  ``fleet_ingest`` with no collective at all;
- ``fleet_merge_sharded`` — each rank sums its devices' packed (U, V)
  payloads per cluster (``segment_sum_mix``), and ONE ``all_reduce`` of
  the (clusters, Ñ, Ñ+m) partials (the reference's ``psum``) completes
  Eq. 8: the collective is O(clusters), never O(devices). The solves run
  through ``from_uv_solve``, once a cluster (isolated) or once for the
  total, and each rank keeps its own devices' P and β. Star,
  hierarchical, all-to-all and the closed ring take this path. The open
  ring takes a halo exchange instead: each rank sends its ``hops`` edge
  payloads to both neighbouring ranks and receives theirs (the
  reference's ``ppermute``, as one batch of sends and receives), then
  runs ``banded_merge_solve`` on the extended block of L + 2·hops devices
  and keeps the middle L, whose windows lie inside the block;
- ``cohort_tree_reduce`` — tier 2 of the two-tier cohort merge: a pairwise
  binary tree over the stacked per-cohort partials, in the reference's
  order; over a mesh each rank folds its contiguous block of cohorts and
  one ``all_reduce`` completes the sum.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.core import OSELMState
from repro_torch.fleet.fleet import _bcast, _packed_uv, _streams_on, fleet_train
from repro_torch.fleet.topology import Topology
from repro_torch.kernels.topology_merge import banded_merge_solve, from_uv_solve, segment_sum_mix

__all__ = ["cohort_tree_reduce", "fleet_merge_sharded", "fleet_train_sharded"]


def _merge_cids(topology: Topology) -> tuple[np.ndarray, int, bool]:
    """(cluster_ids, n_clusters, cluster_isolated) of the topologies whose
    merged model is cluster-wise constant."""
    if topology.kind == "segment":
        return (np.asarray(topology.cluster_ids, np.int32), topology.n_clusters,
                not topology.head_exchange)
    if topology.is_fully_connected:  # all_to_all / closed ring: one cluster
        return np.zeros(topology.n_devices, np.int32), 1, False
    raise NotImplementedError(
        f"sharded merge needs a cluster-wise-constant topology or an open ring; "
        f"{topology.name!r} (kind={topology.kind!r}) mixes per-device neighbor sets "
        "across shard boundaries")


def _local_devices(states: OSELMState, n_devices: int, mesh, axes) -> tuple[int, int]:
    """This rank's block [lo, lo + L) of a fleet of ``n_devices``, checked
    against the block it holds."""
    lo, hi = mesh.block(n_devices, axes, "n_devices")
    if states.beta.shape[0] != hi - lo:
        raise ValueError(f"this rank holds {states.beta.shape[0]} devices; a fleet of "
                         f"{n_devices} over {mesh.size(axes)} shards puts {hi - lo} on each")
    return lo, hi - lo


def fleet_train_sharded(
    states: OSELMState, streams, mesh, axes: Sequence[str] = ("data",)
) -> OSELMState:
    """Per-rank tick ingest of a sharded fleet: ``states`` is this rank's
    block of L devices and ``streams`` the whole fleet's (L·shards, T, n),
    of which it takes its block's rows. Every rank trains only its devices
    (k=1 sequential updates through the fused ``fleet_ingest``): zero
    collectives."""
    xs = _streams_on(states, streams)
    lo, per = _local_devices(states, xs.shape[0], mesh, axes)
    return fleet_train(states, xs[lo : lo + per].contiguous())


def _halo_ring_merge(states: OSELMState, mesh, axis: str, hops: int, ridge: float) -> OSELMState:
    """The open ring on this rank's block: its first and last ``hops``
    payloads go to the previous and next ranks (wrapping), theirs come
    back, and each local device solves its ±hops window inside the
    extended block."""
    _, w = _packed_uv(states, ridge)  # (L, Ñ, Ñ+m)
    n_local = w.shape[0]
    if hops > 0:  # hops = 0 ships nothing: each device merges only itself
        left, right = mesh.ring_exchange(w[n_local - hops :].contiguous(),
                                         w[:hops].contiguous(), axis)
        ext = torch.cat([left, w, right])
    else:
        ext = w
    p, beta = banded_merge_solve(ext.contiguous(), hops, ridge=ridge)
    return states.replace(p=p[hops : hops + n_local].contiguous(),
                          beta=beta[hops : hops + n_local].contiguous())


def fleet_merge_sharded(
    states: OSELMState,
    topology: Topology,
    mesh,
    axes: Sequence[str] = ("data",),
    *,
    ridge: float = 0.0,
) -> OSELMState:
    """The cooperative update of a sharded fleet: ``states`` is this rank's
    block of the ``topology.n_devices`` devices. Returns the block merged:
    one all-reduce of the per-cluster partials, or, on an open ring, the
    halo exchange with both neighbouring ranks."""
    axes = tuple(axes)
    lo, per = _local_devices(states, topology.n_devices, mesh, axes)
    if topology.kind == "banded" and not topology.band_closed:
        if len(axes) != 1:
            raise NotImplementedError("open-ring halo exchange shards over exactly one mesh axis")
        if topology.hops > per:
            raise ValueError(
                f"halo exchange needs hops={topology.hops} <= devices per shard ({per}): a "
                "wider band straddles non-adjacent shards — use fewer shards or the "
                "single-process merge")
        return _halo_ring_merge(states, mesh, axes[0], topology.hops, ridge)

    cids, n_clusters, isolated = _merge_cids(topology)
    local = cids[lo : lo + per]
    n = states.p.shape[-1]
    _, w = _packed_uv(states, ridge)
    sums = mesh.all_reduce(segment_sum_mix(w, local, n_clusters), axes)  # O(clusters)
    if isolated:
        pc, bc = from_uv_solve(sums[:, :, :n], sums[:, :, n:], ridge=ridge)
        at = torch.as_tensor(local, dtype=torch.long, device=pc.device)
        p, beta = pc[at], bc[at]
    else:
        total = sums.sum(0, keepdim=True)
        p1, b1 = from_uv_solve(total[:, :, :n], total[:, :, n:], ridge=ridge)
        p, beta = _bcast(p1[0], per), _bcast(b1[0], per)
    return states.replace(p=p.contiguous(), beta=beta.contiguous())


# ------------------------------------------- inter-cohort tier-2 reduction


def _tree_fold(stack: torch.Tensor) -> torch.Tensor:
    """Pairwise binary-tree sum over the leading axis: each round adds the
    even entries to the odd ones that follow them and carries an odd tail
    last, until one entry is left. The order the paged merge's agreement
    with the flat merge is stated against."""
    while stack.shape[0] > 1:
        n = stack.shape[0]
        even = stack[0 : n - (n % 2) : 2] + stack[1::2]
        if n % 2:
            even = torch.cat([even, stack[n - 1 :]], dim=0)
        stack = even
    return stack[0]


def mesh_tree_reduce(local: torch.Tensor, mesh, axes: Sequence[str] = ("data",)) -> torch.Tensor:
    """Tier 2 over a mesh, from this rank's own block of cohort partials:
    its tree fold, then one all-reduce of the (R, C) partial."""
    if local.shape[0] < 1:
        raise ValueError("each shard needs at least one cohort partial")
    return mesh.all_reduce(_tree_fold(local.to(mesh.device)), tuple(axes))


def cohort_tree_reduce(
    partials, mesh=None, axes: Sequence[str] = ("data",)
) -> torch.Tensor:
    """Reduce the stacked per-cohort partial sums ``(n_cohorts, R, C) →
    (R, C)``: by the pairwise tree on the partials' device (a numpy array is
    taken on the CPU), or over ``mesh``, where each rank folds its
    contiguous block of the cohorts and one all-reduce completes the sum —
    the collective never scales with the number of cohorts."""
    if not isinstance(partials, torch.Tensor):
        partials = torch.from_numpy(np.asarray(partials))
    if partials.ndim < 1 or partials.shape[0] < 1:
        raise ValueError(f"need at least one partial; got shape {tuple(partials.shape)}")
    if mesh is None:
        return _tree_fold(partials)
    lo, hi = mesh.block(partials.shape[0], axes, "n_cohorts")
    return mesh_tree_reduce(partials[lo:hi], mesh, axes)
