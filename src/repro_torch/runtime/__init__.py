"""Resident fleet runtime (port of ``repro.runtime``): detector, governor, tick loop."""
from repro_torch.runtime.detector import (
    DetectorConfig,
    DetectorState,
    detector_update,
    init_detector,
)
from repro_torch.runtime.governor import (
    GovernorConfig,
    GovernorState,
    MergeDecision,
    MergeGovernor,
)
from repro_torch.runtime.runtime import FleetRuntime, RuntimeConfig, TickReport

__all__ = [
    "DetectorConfig", "DetectorState", "detector_update", "init_detector",
    "GovernorConfig", "GovernorState", "MergeDecision", "MergeGovernor",
    "FleetRuntime", "RuntimeConfig", "TickReport",
]
