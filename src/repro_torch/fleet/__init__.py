"""Fleet-scale OS-ELM federation on stacked tensors (port of ``repro.fleet``)."""
from repro_torch.fleet.comm import RoundCost, payload_nbytes, topology_round_cost
from repro_torch.fleet.fleet import (
    fleet_from_uv,
    fleet_merge_masked_kernel,
    fleet_merge_quantized,
    fleet_score,
    fleet_to_uv,
    fleet_train,
    init_fleet,
)
from repro_torch.fleet.partition import (
    DriftEvent,
    FleetStreams,
    make_fleet_streams,
    random_drift_schedule,
)
from repro_torch.fleet.quantize import (
    PRECISIONS,
    apply_codec,
    dequantize_tiles,
    init_residual,
    payload_precision_nbytes,
    quantize_roundtrip,
    quantize_tiles,
    validate_precision,
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
    "fleet_from_uv", "fleet_merge_masked_kernel", "fleet_merge_quantized",
    "fleet_score", "fleet_to_uv", "fleet_train", "init_fleet",
    "DriftEvent", "FleetStreams", "make_fleet_streams", "random_drift_schedule",
    "PRECISIONS", "apply_codec", "dequantize_tiles", "init_residual",
    "payload_precision_nbytes", "quantize_roundtrip", "quantize_tiles",
    "validate_precision",
    "Topology", "all_to_all", "hierarchical", "make_topology", "ring", "star",
]
