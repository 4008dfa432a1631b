"""Scenario evaluation path; port of ``repro.scenarios.evaluate``.

- ``device_auc`` / ``fleet_aucs`` / ``bpnn_auc`` — the §5.3.1 protocol
  (trained patterns normal, held-out pool anomalous) for one OS-ELM state,
  a stacked fleet and the BP-NN baselines;
- ``pair_merge_eval`` / ``pattern_loss_rows`` — the two-device
  cooperative-update evaluations behind the paper's Figs. 6–17;
- ``detection_stats`` — drift detection delay / missed / false-positive
  accounting in the tick clock;
- ``run_scenario`` — a whole ``ScenarioSpec`` end to end through
  ``FleetRuntime`` on any topology, on the card unless ``device="cpu"``:
  local (pre-merge) per-device AUC, post-merge AUC, merges, comm bytes,
  detection stats; a spec with fault schedules runs with its injector and,
  by default, the robust merge.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.baselines.bpnn import BPNNConfig, bpnn_score
from repro_torch.core import ae_score, cooperative_update, to_uv
from repro_torch.data.metrics import roc_auc
from repro_torch.data.pipeline import anomaly_eval_arrays
from repro_torch.data.synthetic import AnomalyDataset
from repro_torch.fleet.fleet import fleet_score, fleet_train
from repro_torch.fleet.robust import RobustConfig
from repro_torch.fleet.topology import Topology, make_topology
from repro_torch.runtime.governor import GovernorConfig
from repro_torch.runtime.runtime import FleetRuntime, RuntimeConfig, TickReport
from repro_torch.scenarios.spec import ScenarioSpec

__all__ = [
    "ScenarioResult",
    "bpnn_auc",
    "detection_stats",
    "device_auc",
    "fleet_aucs",
    "pair_merge_eval",
    "pattern_loss_rows",
    "run_scenario",
    "scenario_topology",
]


# ------------------------------------------------------------ AUC primitives


def device_auc(
    state,
    test: AnomalyDataset,
    normal_patterns,
    *,
    anomaly_ratio: float = 0.1,
    seed: int = 0,
) -> float:
    """§5.3.1 ROC-AUC of one OS-ELM state: ``normal_patterns`` of
    ``test`` are negatives, every other class is subsampled positives."""
    x, y = anomaly_eval_arrays(
        test, list(normal_patterns), anomaly_ratio=anomaly_ratio, seed=seed
    )
    scores = ae_score(state, torch.as_tensor(x, device=state.device))
    return roc_auc(scores.cpu().numpy(), y)


def fleet_aucs(
    states, x_eval: np.ndarray, y_eval: np.ndarray, *, nonfinite: str = "strict"
) -> np.ndarray:
    """Per-device AUC of a stacked fleet on shared eval arrays: (D,).
    ``nonfinite="coerce"`` scores a device whose model gives non-finite
    outputs as 0.5; the default raises on them."""
    x = torch.as_tensor(np.asarray(x_eval, np.float32), device=states.device)
    scores = fleet_score(states, x).cpu().numpy()
    out = []
    for d in range(scores.shape[0]):
        if nonfinite == "coerce" and not np.isfinite(scores[d]).all():
            out.append(0.5)
        else:
            out.append(roc_auc(scores[d], y_eval))
    return np.asarray(out)


def bpnn_auc(params, cfg: BPNNConfig, x_eval: np.ndarray, y_eval: np.ndarray) -> float:
    """The BP-NN baselines scored under the same protocol, on the device
    of their parameters."""
    x = torch.as_tensor(np.asarray(x_eval, np.float32), device=params[0]["w"].device)
    return roc_auc(bpnn_score(params, cfg, x).cpu().numpy(), y_eval)


# -------------------------------------------- two-device paper evaluations


def pair_merge_eval(
    dev_a,
    dev_b,
    test: AnomalyDataset,
    patterns: tuple[int, int],
    *,
    anomaly_ratio: float = 0.1,
    seed: int = 0,
) -> tuple[float, float]:
    """The Figs. 8–17 cell: Device-A's AUC before and after the one-shot
    cooperative update with Device-B, eval normals = both trained
    patterns. Returns ``(auc_before, auc_after)``."""
    before = device_auc(dev_a, test, patterns, anomaly_ratio=anomaly_ratio, seed=seed)
    merged = cooperative_update(dev_a, to_uv(dev_b))
    after = device_auc(merged, test, patterns, anomaly_ratio=anomaly_ratio, seed=seed)
    return before, after


def pattern_loss_rows(
    dev_a, dev_b, test: AnomalyDataset, *, limit: int = 64
) -> dict[str, dict[str, float]]:
    """The Figs. 6/7 bars: per-pattern mean reconstruction loss of
    Device-A before the merge, Device-B, and A after merging B."""
    merged = cooperative_update(dev_a, to_uv(dev_b))
    rows: dict[str, dict[str, float]] = {}
    for pat in test.class_names:
        x = torch.as_tensor(test.pattern(pat)[:limit], device=dev_a.device)
        rows[pat] = {
            "A_before": float(ae_score(dev_a, x).mean()),
            "B": float(ae_score(dev_b, x).mean()),
            "A_after": float(ae_score(merged, x).mean()),
        }
    return rows


# ------------------------------------------------------ detection accounting


def detection_stats(
    detections: list[tuple[int, int]],
    drift_ticks: dict[int, int],
    *,
    truncated_devices: frozenset[int] | set[int] = frozenset(),
) -> dict:
    """Detection-delay accounting in the tick clock: flags BEFORE a
    device's scheduled drift are false positives (they fired on a
    stationary stream); the first flag at/after it is the detection.

    ``truncated_devices`` (``TickFeed.truncated_drift_devices``) are
    devices whose scheduled drift fell entirely in the feed's truncated
    tail: a flag on them is neither a detection nor a false positive, so
    they are excluded from every denominator and reported separately."""
    truncated = frozenset(truncated_devices)
    flags_by_dev: dict[int, list[int]] = {}
    for tick, dev in detections:
        flags_by_dev.setdefault(dev, []).append(tick)
    delays, missed, false_pos = [], [], []
    for dev, flagged in flags_by_dev.items():
        if dev in truncated:
            continue
        if dev not in drift_ticks or min(flagged) < drift_ticks[dev]:
            false_pos.append(dev)
    for dev, t0 in drift_ticks.items():
        post = [t for t in flags_by_dev.get(dev, []) if t >= t0]
        if post:
            delays.append(min(post) - t0)
        else:
            missed.append(dev)
    return {
        "n_drift_events": len(drift_ticks),
        "delays": sorted(delays),
        "delay_mean": float(np.mean(delays)) if delays else None,
        "delay_max": int(np.max(delays)) if delays else None,
        "missed": sorted(missed),
        "false_positives": sorted(false_pos),
        "truncated_drift_devices": sorted(truncated),
    }


# --------------------------------------------------- scenario → FleetRuntime


def scenario_topology(name: str, n_devices: int, **kw) -> Topology:
    """A topology sized to a scenario's fleet. Ring defaults to the
    minimal ±1 gossip band."""
    if name == "ring":
        kw.setdefault("hops", 1)
    return make_topology(name, n_devices, **kw)


@dataclasses.dataclass(frozen=True)
class ScenarioResult:
    """One scenario × topology, end to end through the runtime."""

    spec: ScenarioSpec
    topology: str
    local_aucs: np.ndarray      # (D,) stream-trained only — pre-merge
    merged_aucs: np.ndarray     # (D,) after the runtime's cooperative updates
    merges: int
    comm_bytes: int             # governor ledger: bytes the merges shipped
    detection: dict             # detection_stats output
    reports: list[TickReport]
    payload_precision: str = "f32"   # wire format the merges shipped at
    robust: RobustConfig | None = None  # robust-merge config the run used

    @property
    def clean_devices(self) -> list[int]:
        """Honest devices that never drift: the fleet the AUC claims are
        stated over (a Byzantine device's own model is the attacker's)."""
        drifted = {ev.device for ev in self.spec.drift_schedule()}
        drifted |= set(self.spec.fault_devices())
        return [d for d in range(self.spec.n_devices) if d not in drifted]

    def auc_summary(self) -> dict[str, float]:
        clean = self.clean_devices
        return {
            "local_auc_mean": float(self.local_aucs.mean()),
            "merged_auc_mean": float(self.merged_aucs.mean()),
            "merged_auc_min": float(self.merged_aucs.min()),
            "clean_merged_auc_mean": float(self.merged_aucs[clean].mean()),
        }


# local (no-cooperation) baselines are topology-independent: cache them per
# (spec, key_seed, device) so a topology grid trains the baseline fleet once
_LOCAL_AUC_CACHE: dict[tuple[ScenarioSpec, int, str], np.ndarray] = {}


def _local_aucs(sc, key_seed: int, device: torch.device) -> np.ndarray:
    cache_key = (sc.spec, key_seed, str(device))
    if cache_key not in _LOCAL_AUC_CACHE:
        if len(_LOCAL_AUC_CACHE) > 32:
            _LOCAL_AUC_CACHE.clear()
        fleet = sc.init_fleet(torch.Generator().manual_seed(key_seed), device=device)
        local = fleet_train(fleet, torch.as_tensor(sc.streams.xs, device=device))
        _LOCAL_AUC_CACHE[cache_key] = fleet_aucs(local, sc.x_eval, sc.y_eval)
    return _LOCAL_AUC_CACHE[cache_key]


def run_scenario(
    spec: ScenarioSpec,
    topology: str = "ring",
    *,
    topology_kwargs: dict | None = None,
    merge_every: int = 16,
    gate_merges: bool = True,
    payload_precision: str = "f32",
    key_seed: int = 0,
    scenario=None,
    robust: RobustConfig | str | None = "auto",
    device: str | torch.device | None = None,
) -> ScenarioResult:
    """Drive one built scenario end to end through ``FleetRuntime``.

    Two numbers bracket the paper's claim: ``local_aucs`` (the same
    initial fleet trained on the same streams with no cooperation — the
    "before" column) and ``merged_aucs`` (the runtime's tick loop with
    governed cooperative updates — the "after" column). Both fleets come
    from ``torch.Generator().manual_seed(key_seed)``, so the delta is the
    merges. ``scenario`` takes a pre-built ``spec.build()`` so a topology
    grid shares one stream synthesis; the local baseline is cached per
    (spec, key_seed, device) across topologies. ``device`` defaults to the
    card and raises without one.

    ``robust`` selects the merge's Byzantine defence: ``"auto"`` (default)
    gives ``RobustConfig(trim=1)`` exactly when the spec carries fault
    schedules, so clean presets keep the exact merge; pass a
    ``RobustConfig`` to force one, or None to run a fault-carrying spec
    through the naive merge."""
    device = resolve_device(device)
    sc = spec.build() if scenario is None else scenario
    topo = scenario_topology(topology, spec.n_devices, **(topology_kwargs or {}))
    if robust == "auto":
        robust = RobustConfig(trim=1) if spec.faults else None
    rt = FleetRuntime(
        sc.init_fleet(torch.Generator().manual_seed(key_seed), device=device),
        RuntimeConfig(
            topology=topo,
            ridge=spec.ridge,
            detector=spec.detector,
            governor=GovernorConfig(merge_every=merge_every),
            gate_merges=gate_merges,
            payload_precision=payload_precision,
            robust=robust,
            faults=spec.fault_injector(),
        ),
        device=device,
    )
    feed = sc.feed()
    reports = rt.run(feed)
    return ScenarioResult(
        spec=spec,
        topology=topo.name,
        local_aucs=_local_aucs(sc, key_seed, device),
        merged_aucs=fleet_aucs(rt.states, sc.x_eval, sc.y_eval,
                               nonfinite="coerce" if spec.faults else "strict"),
        merges=rt.governor.state.merges,
        comm_bytes=rt.governor.state.bytes_spent,
        detection=detection_stats(
            rt.detections, feed.drift_ticks(), truncated_devices=feed.truncated_drift_devices
        ),
        reports=reports,
        payload_precision=payload_precision,
        robust=robust,
    )
