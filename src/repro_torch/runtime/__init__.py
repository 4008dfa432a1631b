"""Fleet runtimes (port of ``repro.runtime``): detector, governor, the resident
tick loop and the cohort-paged one."""
from repro_torch.runtime.cohort import CohortFleetRuntime
from repro_torch.runtime.detector import (
    DetectorConfig,
    DetectorState,
    common_mode_ratio,
    detector_update,
    init_detector,
    quarantine_risk,
)
from repro_torch.runtime.feed import TickFeed
from repro_torch.runtime.governor import (
    GovernorConfig,
    GovernorState,
    MergeDecision,
    MergeGovernor,
)
from repro_torch.runtime.runtime import FleetRuntime, RuntimeConfig, TickReport

__all__ = [
    "CohortFleetRuntime",
    "DetectorConfig", "DetectorState", "common_mode_ratio", "detector_update", "init_detector",
    "quarantine_risk", "TickFeed",
    "GovernorConfig", "GovernorState", "MergeDecision", "MergeGovernor",
    "FleetRuntime", "RuntimeConfig", "TickReport",
]
