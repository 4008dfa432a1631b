"""Paper-fidelity workloads as streaming fleet feeds (port of
``repro.scenarios``): ``ScenarioSpec`` and the ``driving``, ``har`` and
``mnist_like`` presets, and ``run_scenario``, which drives one through
``FleetRuntime`` end to end."""
from repro_torch.scenarios.evaluate import (
    ScenarioResult,
    bpnn_auc,
    detection_stats,
    device_auc,
    fleet_aucs,
    pair_merge_eval,
    pattern_loss_rows,
    run_scenario,
    scenario_topology,
)
from repro_torch.scenarios.spec import SCENARIOS, Scenario, ScenarioSpec, make_scenario

__all__ = [
    "SCENARIOS", "Scenario", "ScenarioSpec", "make_scenario",
    "ScenarioResult", "bpnn_auc", "detection_stats", "device_auc", "fleet_aucs",
    "pair_merge_eval", "pattern_loss_rows", "run_scenario", "scenario_topology",
]
