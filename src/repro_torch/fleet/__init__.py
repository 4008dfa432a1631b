"""Fleet-scale OS-ELM federation on stacked tensors (port of ``repro.fleet``)."""
from repro_torch.fleet.comm import (
    RoundCost,
    fedavg_total_cost,
    model_nbytes,
    payload_nbytes,
    topology_round_cost,
)
from repro_torch.fleet.faults import FAULT_KINDS, FaultInjector, FaultSpec
from repro_torch.fleet.fleet import (
    device_state,
    fleet_from_uv,
    fleet_merge,
    fleet_merge_kernel,
    fleet_merge_masked_kernel,
    fleet_merge_quantized,
    fleet_score,
    fleet_to_uv,
    fleet_train,
    fleet_train_rounds,
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
from repro_torch.fleet.robust import (
    RobustConfig,
    finite_payload_mask,
    fleet_merge_robust,
    payload_clip,
    payload_outlier_scores,
    robust_merge_from_w,
)
from repro_torch.fleet.staleness import StalenessSchedule, fleet_train_async
from repro_torch.fleet.topology import (
    Topology,
    all_to_all,
    hierarchical,
    make_topology,
    ring,
    star,
)

__all__ = [
    "RoundCost", "fedavg_total_cost", "model_nbytes", "payload_nbytes",
    "topology_round_cost",
    "FAULT_KINDS", "FaultInjector", "FaultSpec",
    "device_state", "fleet_from_uv", "fleet_merge", "fleet_merge_kernel",
    "fleet_merge_masked_kernel", "fleet_merge_quantized",
    "fleet_score", "fleet_to_uv", "fleet_train", "fleet_train_rounds", "init_fleet",
    "DriftEvent", "FleetStreams", "make_fleet_streams", "random_drift_schedule",
    "PRECISIONS", "apply_codec", "dequantize_tiles", "init_residual",
    "payload_precision_nbytes", "quantize_roundtrip", "quantize_tiles",
    "validate_precision",
    "RobustConfig", "finite_payload_mask", "fleet_merge_robust", "payload_clip",
    "payload_outlier_scores", "robust_merge_from_w",
    "StalenessSchedule", "fleet_train_async",
    "Topology", "all_to_all", "hierarchical", "make_topology", "ring", "star",
]
