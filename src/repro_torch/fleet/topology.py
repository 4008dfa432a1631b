"""Merge topologies for fleet cooperative updates; port of
``repro.fleet.topology``.

Eq. 8 is a plain sum of per-device (U, V), so every topology is a 0/1
summation pattern M over the device axis (Mᵢᵢ = 1):

- ``all_to_all`` — every device exchanges with every peer (M = 1);
- ``star`` — upload to a hub, sum, broadcast back: the result equals
  all-to-all at O(D) traffic;
- ``ring`` — gossip with the ±``hops`` ring neighbours;
- ``hierarchical`` — contiguous location clusters sum locally; with
  head exchange the result equals all-to-all, without it the clusters
  stay isolated.

The merge kernels (``repro_torch.kernels.topology_merge``) read the
sparse structure (``kind``, ``cluster_ids``, ``hops``) directly; M is
formed only by ``dense_matrix`` (and read by ``Topology.mix`` on a dense
topology).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class Topology:
    """A merge pattern over ``n_devices`` stacked learners. ``kind`` is
    "dense" (``matrix``), "banded" (circular ±``hops``) or "segment"
    (two-tier sum over ``cluster_ids``, plus a head exchange when
    ``head_exchange``)."""

    name: str
    n_devices: int
    kind: str
    matrix: np.ndarray | None = None
    cluster_ids: np.ndarray | None = None
    n_clusters: int | None = None
    hops: int | None = None
    head_exchange: bool = True
    payloads_per_round: int = 0

    def dense_matrix(self) -> np.ndarray:
        """The equivalent (D, D) mixing mask, whatever the kind."""
        if self.matrix is not None:
            return self.matrix
        if self.kind == "banded":
            idx = np.arange(self.n_devices)
            dist = np.abs(idx[:, None] - idx[None, :])
            circ = np.minimum(dist, self.n_devices - dist)
            return (circ <= self.hops).astype(np.float32)
        same = self.cluster_ids[:, None] == self.cluster_ids[None, :]
        if self.head_exchange:
            return np.ones_like(same, dtype=np.float32)
        return same.astype(np.float32)

    def mix(self, stacked):
        """Neighbour-sum a stacked (D, R, C) tensor: out[i] = Σⱼ Mᵢⱼ x[j],
        through ``repro_torch.kernels.topology_merge.topology_mix`` (the
        kernels on a CUDA tensor, their plain versions on a CPU one); the
        sparse kinds never form M."""
        from repro_torch.kernels.topology_merge import topology_mix

        return topology_mix(stacked, self)

    @property
    def band_closed(self) -> bool:
        """A ring whose ±hops window covers every device (all-to-all)."""
        return self.kind == "banded" and 2 * self.hops + 1 >= self.n_devices

    @property
    def is_fully_connected(self) -> bool:
        if self.kind == "segment":
            return self.head_exchange or self.n_clusters == 1
        if self.kind == "banded":
            return self.band_closed
        return bool((self.dense_matrix() > 0).all())


def all_to_all(n_devices: int) -> Topology:
    """Full D2D mesh: D(D−1) payload transmissions per round."""
    return Topology(
        name="all_to_all",
        n_devices=n_devices,
        kind="dense",
        matrix=np.ones((n_devices, n_devices), dtype=np.float32),
        payloads_per_round=n_devices * (n_devices - 1),
    )


def star(n_devices: int) -> Topology:
    """Hub topology: 2(D−1) payloads per round, one cluster."""
    return Topology(
        name="star",
        n_devices=n_devices,
        kind="segment",
        cluster_ids=np.zeros(n_devices, dtype=np.int32),
        n_clusters=1,
        head_exchange=True,
        payloads_per_round=2 * (n_devices - 1),
    )


def ring(n_devices: int, hops: int = 1) -> Topology:
    """Gossip ring: device i merges with its ±1..hops neighbours."""
    degree = min(2 * hops, n_devices - 1)
    return Topology(
        name=f"ring{hops}" if hops != 1 else "ring",
        n_devices=n_devices,
        kind="banded",
        hops=hops,
        payloads_per_round=n_devices * degree,
    )


def hierarchical(
    n_devices: int, n_clusters: int, *, head_exchange: bool = True
) -> Topology:
    """Contiguous location clusters; (D − C) member uploads and
    downloads plus C(C−1) head exchanges per round."""
    if not 1 <= n_clusters <= n_devices:
        raise ValueError(f"need 1 <= n_clusters={n_clusters} <= n_devices={n_devices}")
    cluster_ids = (np.arange(n_devices) * n_clusters // n_devices).astype(np.int32)
    head_traffic = n_clusters * (n_clusters - 1) if head_exchange else 0
    return Topology(
        name="hierarchical" if head_exchange else "hierarchical_isolated",
        n_devices=n_devices,
        kind="segment",
        cluster_ids=cluster_ids,
        n_clusters=n_clusters,
        head_exchange=head_exchange,
        payloads_per_round=2 * (n_devices - n_clusters) + head_traffic,
    )


TOPOLOGIES = {
    "all_to_all": all_to_all,
    "star": star,
    "ring": ring,
    "hierarchical": lambda n, **kw: hierarchical(n, max(1, n // 8), **kw),
}


def make_topology(name: str, n_devices: int, **kw) -> Topology:
    try:
        return TOPOLOGIES[name](n_devices, **kw)
    except KeyError as e:
        raise ValueError(f"unknown topology {name!r}; have {sorted(TOPOLOGIES)}") from e

