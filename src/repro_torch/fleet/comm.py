"""Per-round communication cost of a topology, f32 payloads; port of
``repro.fleet.comm``. One payload is Ñ(Ñ+m) values: U (Ñ, Ñ) and
V (Ñ, m)."""
from __future__ import annotations

import dataclasses

from repro_torch.fleet.topology import Topology


def payload_nbytes(n_hidden: int, n_out: int, itemsize: int = 4) -> int:
    return n_hidden * (n_hidden + n_out) * itemsize


@dataclasses.dataclass(frozen=True)
class RoundCost:
    topology: str
    n_devices: int
    payloads: int
    bytes_total: int
    precision: str = "f32"

    @property
    def bytes_per_device(self) -> float:
        return self.bytes_total / max(self.n_devices, 1)


def topology_round_cost(
    topology: Topology, n_hidden: int, n_out: int, itemsize: int = 4
) -> RoundCost:
    """Traffic of one cooperative update over ``topology``."""
    return RoundCost(
        topology=topology.name,
        n_devices=topology.n_devices,
        payloads=topology.payloads_per_round,
        bytes_total=topology.payloads_per_round * payload_nbytes(n_hidden, n_out, itemsize),
    )
