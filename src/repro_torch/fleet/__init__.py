"""Fleet-scale OS-ELM federation on stacked tensors (port of ``repro.fleet``)."""
from repro_torch.fleet.comm import RoundCost, payload_nbytes, topology_round_cost
from repro_torch.fleet.fleet import (
    fleet_from_uv,
    fleet_merge,
    fleet_merge_masked,
    fleet_merge_masked_kernel,
    fleet_score,
    fleet_to_uv,
    fleet_train,
    init_fleet,
)
from repro_torch.fleet.topology import (
    Topology,
    all_to_all,
    hierarchical,
    make_topology,
    ring,
    star,
)

__all__ = [
    "RoundCost", "payload_nbytes", "topology_round_cost",
    "fleet_from_uv", "fleet_merge", "fleet_merge_masked",
    "fleet_merge_masked_kernel", "fleet_score", "fleet_to_uv", "fleet_train",
    "init_fleet",
    "Topology", "all_to_all", "hierarchical", "make_topology", "ring", "star",
]
