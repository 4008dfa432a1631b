"""Per-round communication cost of a topology; port of
``repro.fleet.comm``. One payload is Ñ(Ñ+m) values: U (Ñ, Ñ) and
V (Ñ, m); a lossy ``precision`` counts them at the wire codec's exact
size (``repro_torch.fleet.quantize``)."""
from __future__ import annotations

import dataclasses

from repro_torch.fleet.quantize import payload_precision_nbytes
from repro_torch.fleet.topology import Topology


def payload_nbytes(
    n_hidden: int, n_out: int, itemsize: int = 4, *, precision: str | None = None
) -> int:
    """Ñ(Ñ+m) values at ``itemsize``, or at ``precision``'s wire size (int8
    adds one f32 scale per column tile)."""
    if precision is not None:
        return payload_precision_nbytes(n_hidden, n_out, precision)
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
    topology: Topology, n_hidden: int, n_out: int, itemsize: int = 4, *, precision: str = "f32"
) -> RoundCost:
    """Traffic of one cooperative update over ``topology``, every payload
    at ``precision`` (f32 keeps the raw ``itemsize``)."""
    nbytes = payload_nbytes(
        n_hidden, n_out, itemsize, precision=None if precision == "f32" else precision
    )
    return RoundCost(
        topology=topology.name,
        n_devices=topology.n_devices,
        payloads=topology.payloads_per_round,
        bytes_total=topology.payloads_per_round * nbytes,
        precision=precision,
    )
