"""Byzantine-robust cooperative merges under fault injection, and crash
recovery, on the port (the PyTorch counterpart of
``benchmarks/robust_fleet.py``), on the card.

The paper's Eq. 8 merge sums every neighbour's (U, V) as it comes, so one
device shipping a scaled or negated payload poisons its whole
neighbourhood. With deterministic fault schedules
(``repro_torch.fleet.faults``) at 10 % Byzantine devices the harness runs:

1. **clean**: the preset with no faults through the exact merge, the lock
   every robust claim is stated against;
2. **robust**: 10 % of the devices ship ×−25 payloads through the trimmed
   merge (``RobustConfig(trim=max(1, attackers))``): the honest devices'
   merged AUC stays within ``AUC_BAND`` of the clean lock;
3. **naive**: the same attack through the plain masked merge: the honest
   AUC falls below lock − ``AUC_BAND``, or the robust arm defends against
   nothing.

``driving`` on a ring runs the banded trimmed gather, ``har`` on a star
the cluster-segment trimmed sum.

4. **chaos**: NaN payloads from 10 % of the devices (each one rejected by
   the finite guard), snapshots every 16 ticks, the runtime killed at tick
   40, its newest snapshot cut to 128 bytes, a new runtime restored from
   the one before (the walk-back) and replayed to the end. The replayed
   tail equals the uninterrupted run's tail: losses, flags, decisions,
   robust scores and non-finite counts; the telemetry counters carry on
   where they were. The port runs eagerly, so the reference's
   compile-once check has no counterpart; in its place, on the card, the
   replayed tail launches each kernel as often as the uninterrupted run's
   tail does (``repro_torch.kernels.launch_counts``).

Artifacts: ``BENCH_torch_robust_fleet.json`` (written before the asserts)
and a ``BENCH_torch_history.jsonl`` entry keyed by the card's name
(``benchmarks/torch_history.py``); the ``*_robust_vs_naive_ratio`` keys
gate as higher-is-better.

    python benchmarks/torch_robust_fleet.py [--smoke|--full] [--device cpu]

The default device is the card; ``--device cpu`` is a rehearsal whose
times are the host's, not the card's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.torch_history import backend_of, record_and_gate  # noqa: E402
from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.fleet import FaultSpec, RobustConfig  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.obs import TelemetryConfig  # noqa: E402
from repro_torch.runtime import FleetRuntime, GovernorConfig, RuntimeConfig  # noqa: E402
from repro_torch.scenarios import make_scenario, run_scenario, scenario_topology  # noqa: E402

MERGE_EVERY = 16
AUC_BAND = 0.03            # the robust arm stays inside, the naive arm falls below
BYZANTINE = FaultSpec(kind="scale", frac=0.1, magnitude=-25.0, seed=7)

# preset → (sizes, topology, topology kwargs): the ring drives the banded
# trimmed gather, the star the cluster-segment trimmed sum. A band must hold
# more than 2·trim participants for the trim to engage, so the full grid's
# bigger ring widens its band to cover a trim of 2 (2·2 + 1 = 5 > 4).
SMOKE_GRID = {
    "driving": ({"n_devices": 10, "ticks": 80}, "ring", {}),
    "har": ({"n_devices": 20, "ticks": 80}, "star", {}),
}
FULL_GRID = {
    "driving": ({"n_devices": 20, "ticks": 120}, "ring", {"hops": 2}),
    "har": ({"n_devices": 30, "ticks": 120}, "star", {}),
}

CHAOS_SIZES = {"n_devices": 10, "ticks": 64}
CHAOS_SNAPSHOT_EVERY = 16
CHAOS_KILL_TICK = 40       # between snapshots: the restore rewinds, then replays
CHAOS_NAN = FaultSpec(kind="nan", frac=0.1, start_tick=8, seed=3)


def run_grid(grid: dict, *, seed: int = 0, device: torch.device) -> dict:
    """Every preset through the three arms on its topology. The scenario
    is built once a preset, so every arm trains the same fleet on the same
    data; the claims are stated over the honest devices (neither Byzantine
    nor drifted), the same in every arm."""
    rows = {}
    for name, (sizes, topology, topo_kwargs) in grid.items():
        spec = make_scenario(name, **sizes)
        spec_byz = dataclasses.replace(spec, faults=(BYZANTINE,))
        sc = spec.build()
        # the trimmed mean tolerates at most `trim` attackers a reduction
        # group: the budget is sized to the attack
        n_byz = len(spec_byz.fault_devices())
        arms: dict[str, dict] = {}
        aucs: dict[str, np.ndarray] = {}
        for arm, (arm_spec, robust) in {
            "clean": (spec, None),
            "robust": (spec_byz, RobustConfig(trim=max(1, n_byz))),
            "naive": (spec_byz, None),
        }.items():
            reset_launch_counts()
            t0 = time.perf_counter()
            res = run_scenario(
                arm_spec, topology, topology_kwargs=topo_kwargs or None,
                merge_every=MERGE_EVERY, key_seed=seed, scenario=sc, robust=robust,
                telemetry=TelemetryConfig(), device=device,
            )
            aucs[arm] = res.merged_aucs
            tel = res.telemetry
            rep_nonfinite = int(sum(r.nonfinite_payloads for r in res.reports))
            # the sink's counters and the reports are two views of the same
            # events
            assert tel["nonfinite_payloads_total"] == rep_nonfinite, (
                name, arm, tel["nonfinite_payloads_total"], rep_nonfinite)
            assert tel["merge_rounds"] == res.merges, (name, arm, tel)
            arms[arm] = {
                **res.auc_summary(),
                "merges": res.merges,
                "comm_bytes": res.comm_bytes,
                "nonfinite_payloads": rep_nonfinite,
                "tick_p50_us": tel["tick_latency"]["p50_s"] * 1e6,
                "wall_seconds": time.perf_counter() - t0,
                "launches": {k: v for k, v in launch_counts().items() if v},
            }
        drifted = {ev.device for ev in spec.drift_schedule()}
        honest = [d for d in range(spec.n_devices)
                  if d not in set(spec_byz.fault_devices()) and d not in drifted]
        honest_auc = {a: float(aucs[a][honest].mean()) for a in aucs}
        rows[name] = {
            "preset": name,
            "topology": topology,
            "sizes": sizes,
            "byzantine_devices": list(spec_byz.fault_devices()),
            "honest_devices": honest,
            "honest_merged_auc": honest_auc,
            "robust_margin": honest_auc["robust"] - honest_auc["clean"],
            "naive_margin": honest_auc["naive"] - honest_auc["clean"],
            "arms": arms,
        }
    return rows


def _same(a, b) -> bool:
    """Two reports of one tick equal: losses, flags, decision, non-finite
    count and robust scores."""
    scores = ((a.robust_scores is None) == (b.robust_scores is None)
              and (a.robust_scores is None
                   or np.array_equal(a.robust_scores, b.robust_scores)))
    return (np.array_equal(a.losses, b.losses, equal_nan=True)
            and np.array_equal(a.drifted, b.drifted)
            and np.array_equal(a.fresh_detections, b.fresh_detections)
            and a.decision == b.decision
            and a.nonfinite_payloads == b.nonfinite_payloads and scores)


def chaos_recovery(*, seed: int = 0, device: torch.device) -> dict:
    """NaN payloads, a crash between snapshots and a corrupt newest
    snapshot; the restored runtime replayed against an uninterrupted run."""
    spec = dataclasses.replace(make_scenario("driving", **CHAOS_SIZES), faults=(CHAOS_NAN,))
    sc = spec.build()
    topo = scenario_topology("star", spec.n_devices)
    feed = sc.feed()
    ticks = spec.ticks

    def runtime(snapshot_dir=None, telemetry_dir=None):
        config = RuntimeConfig(
            topology=topo, ridge=spec.ridge, detector=spec.detector,
            governor=GovernorConfig(merge_every=MERGE_EVERY),
            robust=RobustConfig(trim=1), faults=spec.fault_injector(),
            snapshot_every=CHAOS_SNAPSHOT_EVERY if snapshot_dir else None,
            snapshot_dir=snapshot_dir, telemetry=TelemetryConfig(dir=telemetry_dir),
        )
        fleet = sc.init_fleet(torch.Generator().manual_seed(seed), device=device)
        return FleetRuntime(fleet, config, device=device)

    t0 = time.perf_counter()
    # the uninterrupted run (an in-memory sink: the continuity baseline),
    # with the launch counts after every tick
    ref = runtime()
    reset_launch_counts()
    ref_reports, counts_after = [], []
    for t in range(ticks):
        ref_reports.append(ref.tick(feed.tick_batch(t)))
        counts_after.append(launch_counts())
    ref_summary = ref.finalize_telemetry()

    with tempfile.TemporaryDirectory() as tmp:
        tel_dir = str(Path(tmp) / "telemetry")
        doomed = runtime(tmp, tel_dir)
        doomed.run(feed, ticks=CHAOS_KILL_TICK)
        doomed_dumps = list(doomed.telemetry.flight.dumps)
        assert doomed_dumps, "no flight dump before the crash"
        del doomed  # the crash

        # the crash also tore the newest snapshot: the restore warns and
        # falls back to the step before
        newest = sorted(Path(tmp).glob("ckpt_*.npz"))[-1]
        snapshot_bytes = newest.stat().st_size
        newest.write_bytes(newest.read_bytes()[:128])

        revived = runtime(tmp, tel_dir)
        t1 = time.perf_counter()
        restored_tick = revived.restore()
        restore_seconds = time.perf_counter() - t1
        restored_ticks_counter = int(revived.telemetry.ticks.value)
        reset_launch_counts()
        replay_reports = [revived.tick(feed.tick_batch(t)) for t in range(restored_tick, ticks)]
        replay_launches = launch_counts()
        revived_summary = revived.finalize_telemetry()
        flight_dumps = [Path(p).name for p in doomed_dumps]
    wall = time.perf_counter() - t0

    before = counts_after[restored_tick - 1] if restored_tick else dict.fromkeys(replay_launches, 0)
    tail_launches = {k: counts_after[-1][k] - before[k] for k in replay_launches}
    mismatches = [a.tick for a, b in zip(ref_reports[restored_tick:], replay_reports)
                  if not _same(a, b)]
    beta_err = float((ref.states.beta - revived.states.beta).abs().max())
    return {
        "ticks": ticks,
        "kill_tick": CHAOS_KILL_TICK,
        "restored_tick": restored_tick,
        "corrupted_newest_snapshot": True,
        "snapshot_bytes": snapshot_bytes,
        "restore_seconds": restore_seconds,
        "nonfinite_rejected_ref": int(sum(r.nonfinite_payloads for r in ref_reports)),
        "nonfinite_rejected_replay": int(sum(r.nonfinite_payloads for r in replay_reports)),
        "tick_mismatches": mismatches,
        "final_beta_max_abs_err": beta_err,
        "tail_launches": {k: v for k, v in tail_launches.items() if v},
        "replay_launches": {k: v for k, v in replay_launches.items() if v},
        "restored_ticks_counter": restored_ticks_counter,
        "flight_dumps_before_crash": flight_dumps,
        "telemetry_continuity": {
            "ref_ticks": ref_summary["ticks"],
            "revived_ticks": revived_summary["ticks"],
            "ref_nonfinite": ref_summary["nonfinite_payloads_total"],
            "revived_nonfinite": revived_summary["nonfinite_payloads_total"],
            "ref_merge_rounds": ref_summary["merge_rounds"],
            "revived_merge_rounds": revived_summary["merge_rounds"],
        },
        "wall_seconds": wall,
    }


def run_bench(*, smoke: bool = True, seed: int = 0,
              device: str | torch.device | None = None) -> dict:
    device = resolve_device(device)
    grid = SMOKE_GRID if smoke else FULL_GRID
    return {
        "backend": backend_of(device),
        "smoke": smoke,
        "merge_every": MERGE_EVERY,
        "auc_band": AUC_BAND,
        "attack": {"kind": BYZANTINE.kind, "frac": BYZANTINE.frac,
                   "magnitude": BYZANTINE.magnitude},
        "presets": run_grid(grid, seed=seed, device=device),
        "chaos": chaos_recovery(seed=seed, device=device),
    }


def check_claims(report: dict) -> None:
    """The robustness and crash-recovery claims, as the reference asserts
    them (and, on the card, the replay's launches)."""
    for name, row in report["presets"].items():
        auc, arms = row["honest_merged_auc"], row["arms"]
        assert row["byzantine_devices"], f"{name}: the attack resolved no victims"
        for arm in ("clean", "robust", "naive"):
            assert arms[arm]["merges"] >= 1, f"{name}/{arm}: no merges admitted"
        assert abs(auc["robust"] - auc["clean"]) <= AUC_BAND, (
            f"{name}: robust honest AUC {auc['robust']:.3f} outside ±{AUC_BAND} of the clean "
            f"lock {auc['clean']:.3f}")
        assert auc["naive"] < auc["clean"] - AUC_BAND, (
            f"{name}: naive honest AUC {auc['naive']:.3f} did not fall below the clean lock "
            f"{auc['clean']:.3f} − {AUC_BAND}: the attack is too weak to test the defence")
    chaos = report["chaos"]
    assert chaos["nonfinite_rejected_ref"] > 0, "the NaN arm rejected no payloads"
    assert chaos["nonfinite_rejected_replay"] > 0, "the replayed tail rejected no payloads"
    assert not chaos["tick_mismatches"], (
        f"the replay diverged from the uninterrupted run at ticks {chaos['tick_mismatches']}")
    assert chaos["final_beta_max_abs_err"] <= 1e-5, chaos["final_beta_max_abs_err"]
    assert chaos["restored_tick"] < chaos["kill_tick"], (
        "the restore did not rewind past the corrupted snapshot")
    # the restored registry resumed mid-count and the replay's final counters
    # equal the uninterrupted run's
    assert chaos["restored_ticks_counter"] == chaos["restored_tick"], chaos
    cont = chaos["telemetry_continuity"]
    assert cont["revived_ticks"] == cont["ref_ticks"], cont
    assert cont["revived_nonfinite"] == cont["ref_nonfinite"], cont
    assert cont["revived_merge_rounds"] == cont["ref_merge_rounds"], cont
    assert chaos["flight_dumps_before_crash"], chaos
    if report["backend"] != "cpu":
        assert chaos["replay_launches"] == chaos["tail_launches"], (
            f"the replay launched {chaos['replay_launches']}, the uninterrupted tail "
            f"{chaos['tail_launches']}")
        assert chaos["replay_launches"].get("fleet_ingest", 0) > 0, chaos["replay_launches"]


def main(
    smoke: bool = True,
    out_path: str = "BENCH_torch_robust_fleet.json",
    history_path: str = "BENCH_torch_history.jsonl",
    device: str | torch.device | None = None,
) -> list[str]:
    report = run_bench(smoke=smoke, device=device)
    # persist before asserting: a failed claim still leaves the artifact
    with open(out_path, "w") as fh:
        json.dump(report, fh, indent=2)

    lines = []
    metrics: dict[str, float] = {}
    for name, row in report["presets"].items():
        auc = row["honest_merged_auc"]
        for arm in ("clean", "robust", "naive"):
            r = row["arms"][arm]
            wall_us = r["wall_seconds"] * 1e6
            metrics[f"{name}_{arm}_us"] = wall_us
            lines.append(
                f"torch_robust_fleet/{name}/{arm},{wall_us:.1f},"
                f"topo={row['topology']};honest_auc={auc[arm]:.3f};"
                f"merges={r['merges']};nonfinite={r['nonfinite_payloads']};"
                f"launches={r['launches']}")
        # higher is better: the defence's margin over the naive merge
        metrics[f"{name}_robust_vs_naive_ratio"] = auc["robust"] / max(auc["naive"], 1e-9)

    chaos = report["chaos"]
    metrics["chaos_recovery_us"] = chaos["wall_seconds"] * 1e6
    lines.append(
        f"torch_robust_fleet/chaos,{chaos['wall_seconds'] * 1e6:.1f},"
        f"restored_tick={chaos['restored_tick']};"
        f"nonfinite_rejected={chaos['nonfinite_rejected_ref']};"
        f"tick_mismatches={len(chaos['tick_mismatches'])};"
        f"beta_err={chaos['final_beta_max_abs_err']:.2e};"
        f"snapshot_bytes={chaos['snapshot_bytes']};restore_s={chaos['restore_seconds']:.4f};"
        f"replay_launches={chaos['replay_launches']}")
    check_claims(report)
    lines.append(
        f"# torch_robust_fleet claims ok — 10% Byzantine held to ±{AUC_BAND} on "
        f"{sorted(report['presets'])}; naive degraded; crash/restore tick-identical from "
        f"tick {chaos['restored_tick']} on {report['backend']} → {out_path}")
    # the history gate after the claims; wall clocks take the scenario builds
    # and, on a fresh checkout, the kernel build: gate generously
    record_and_gate("torch_robust_fleet", metrics, backend=report["backend"],
                    path=history_path, threshold=0.5)
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the chaos grid: 2 presets × 3 arms and the crash/restore (the default)")
    ap.add_argument("--full", action="store_true", help="bigger fleets, longer soaks")
    ap.add_argument("--out", default="BENCH_torch_robust_fleet.json")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    for line in main(smoke=not args.full, out_path=args.out, device=args.device):
        print(line)
    print(f"# torch_robust_fleet ok ({'full' if args.full else 'smoke'})")
