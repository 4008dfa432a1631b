"""Paper §5 headline tables on the port — the one-shot cooperative update
against BP-NN and R-round FedAvg at matched communication rounds (the
PyTorch counterpart of ``benchmarks/paper_eval.py``), on the card.

For every clean paper-analog scenario (``driving`` / ``har`` /
``mnist_like``, ``repro_torch.scenarios``) the harness:

1. drives the scenario end to end through ``FleetRuntime`` on each
   topology (smoke: ring + star — the paper's D2D gossip and its Fig. 4/5
   server exchange; ``--full`` adds all_to_all + hierarchical) with
   telemetry on, reporting per-device (local, pre-merge) and post-merge
   ROC-AUC, merges, bytes and the tick's p50/p99 from the sink;
2. trains the BP-NN3 autoencoder baseline on the pooled normal-phase
   data — the centralized comparison point of Figs. 10/11/15/16;
3. runs BP-NN3-FL for R = (the grid's largest admitted merge count)
   rounds and prices each topology's FedAvg at its own merge count.

Asserted (as the reference asserts):
  - the sink's bytes and rounds equal the governor's ledger on every run;
  - every scenario runs green on every topology (≥1 admitted merge,
    finite AUCs);
  - at least one scenario's clean-device merged AUC is within 0.02 of
    BP-NN on every asserted topology AND ships fewer bytes than FedAvg by
    the precision's factor (f32 5×, f16 10×, int8 60×); all_to_all is
    reported, not asserted;
  - on a CUDA device, every kernel the grid routes to was launched
    (``repro_torch.kernels.launch_counts``): the eager port's counterpart
    of the reference's compile-once claim.

Artifacts: ``BENCH_torch_paper_eval.json`` (``_f16``, ``_q`` for the
lossy precisions) and a ``BENCH_torch_history.jsonl`` entry a run, keyed
by the card's name (``benchmarks/torch_history.py``).

    python benchmarks/torch_paper_eval.py --smoke [--payload-precision int8] [--device cpu]

The default device is the card; ``--device cpu`` is a rehearsal whose
times are the host's, not the card's.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.torch_history import backend_of, record_and_gate  # noqa: E402
from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.baselines import bpnn3_config, run_fedavg, train_bpnn  # noqa: E402
from repro_torch.baselines.fedavg import FedAvgConfig  # noqa: E402
from repro_torch.fleet.comm import fedavg_total_cost  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.obs import TelemetryConfig  # noqa: E402
from repro_torch.scenarios import SCENARIOS, bpnn_auc, make_scenario, run_scenario  # noqa: E402

MERGE_EVERY = 16
BPNN_HIDDEN = 128          # BP-NN3 width (its model is what FedAvg ships)
BPNN_EPOCHS = 6
AUC_MARGIN = 0.02          # "as accurately as BP-NN": within this margin
COMM_FACTOR = 5.0          # proposed ships ≥5× fewer bytes than FedAvg
COMM_FACTOR_QUANTIZED = 60.0
COMM_FACTOR_BY_PRECISION = {"f32": COMM_FACTOR, "f16": 10.0, "int8": COMM_FACTOR_QUANTIZED}

SMOKE_SIZES = {"n_devices": 8, "ticks": 80}
FULL_SIZES = {"n_devices": 24, "ticks": 120}
SMOKE_TOPOLOGIES = ("ring", "star")
FULL_TOPOLOGIES = ("ring", "star", "hierarchical", "all_to_all")
# the full-mesh D2D exchange is the paper's expensive baseline — its comm
# ratio is reported but never asserted against COMM_FACTOR
UNASSERTED_TOPOLOGIES = ("all_to_all",)

# the merge kernels each topology of the grid routes an admitted round to
# (fleet_ingest runs every tick; quantize_pack every int8 round)
MERGE_ROUTES = {
    "ring": ("banded_merge_solve",),   # the open ±1 ring: the fused banded merge + solve
    "star": ("masked_segment_sum_mix", "from_uv_solve"),
    "hierarchical": ("masked_segment_sum_mix", "from_uv_solve"),
    "all_to_all": ("from_uv_solve",),  # one sum, one solve
}
PAPER_EVAL_FILES = {"f32": "BENCH_torch_paper_eval.json", "f16": "BENCH_torch_paper_eval_f16.json",
                    "int8": "BENCH_torch_paper_eval_q.json"}
BENCH_NAMES = {"f32": "torch_paper_eval", "f16": "torch_paper_eval_f16",
               "int8": "torch_paper_eval_q"}


def routed_kernels(topology: str, payload_precision: str) -> tuple[str, ...]:
    """The kernels a run of the grid on ``topology`` must launch."""
    extra = ("quantize_pack",) if payload_precision == "int8" else ()
    return ("fleet_ingest", *MERGE_ROUTES[topology], *extra)


def _normal_phase_pool(sc) -> tuple[np.ndarray, list[np.ndarray]]:
    """Training data the baselines may see: every device's normal-phase
    samples. Returns (pooled (N, F) for BP-NN, per-device list for
    FedAvg)."""
    mask = sc.streams.pattern_of_device < sc.spec.n_normal
    per_device = [sc.streams.xs[d][mask[d]] for d in range(sc.spec.n_devices)]
    return np.concatenate(per_device), per_device


def eval_scenario(
    name: str,
    sizes: dict,
    topologies: tuple[str, ...],
    *,
    seed: int = 0,
    payload_precision: str = "f32",
    device: str | torch.device | None = None,
    scenario=None,
    fleet=None,
    bpnn_params=None,
    fedavg_params=None,
) -> dict:
    """One scenario row of the headline table, on ``device`` (the card
    unless ``device="cpu"``). ``scenario`` takes a pre-built
    ``make_scenario(name, **sizes).build()``; ``fleet``, ``bpnn_params`` and
    ``fedavg_params`` the initial fleet and networks, which otherwise come
    from ``torch.Generator().manual_seed(seed)`` (``seed + 1`` for FedAvg),
    as ``run_scenario``'s do."""
    device = resolve_device(device)
    spec = make_scenario(name, **sizes)
    sc = spec.build() if scenario is None else scenario
    if fleet is not None:
        fleet = fleet.replace(params=type(fleet.params)(*(t.to(device) for t in fleet.params)),
                              beta=fleet.beta.to(device), p=fleet.p.to(device))

    rows: dict[str, dict] = {}
    for topo in topologies:
        reset_launch_counts()
        t0 = time.perf_counter()
        res = run_scenario(
            spec, topo, merge_every=MERGE_EVERY, key_seed=seed, scenario=sc,
            payload_precision=payload_precision, telemetry=TelemetryConfig(), device=device,
            fleet=fleet,
        )
        wall = time.perf_counter() - t0
        counts = launch_counts()
        # the sink's ledger must agree with the governor's: same bytes, same
        # admitted rounds
        tel = res.telemetry
        assert tel is not None and tel["bytes_total"] == res.comm_bytes, (
            f"{name}/{topo}: telemetry bytes {tel and tel['bytes_total']} "
            f"!= governor ledger {res.comm_bytes}")
        assert tel["merge_rounds"] == res.merges, (
            f"{name}/{topo}: telemetry rounds {tel['merge_rounds']} "
            f"!= governor merges {res.merges}")
        det = res.detection
        rows[topo] = {
            **res.auc_summary(),
            "merges": res.merges,
            "comm_bytes": res.comm_bytes,
            "bytes_per_merge": res.comm_bytes / max(res.merges, 1),
            "detection_delay_mean": det["delay_mean"],
            "missed_detections": len(det["missed"]),
            "false_positives": len(det["false_positives"]),
            "detections_total": tel["detections_total"],
            "wall_seconds": wall,
            "tick_p50_us": tel["tick_latency"]["p50_s"] * 1e6,
            "tick_p99_us": tel["tick_latency"]["p99_s"] * 1e6,
            "launches": ({k: counts[k] for k in routed_kernels(topo, payload_precision)}
                         if device.type == "cuda" else None),
        }

    # ---- BP-NN3 centralized baseline on the pooled normal-phase data
    x_pool, per_device = _normal_phase_pool(sc)
    cfg = bpnn3_config(sc.n_features, BPNN_HIDDEN, batch=8, epochs=BPNN_EPOCHS)
    t0 = time.perf_counter()
    params = train_bpnn(torch.Generator().manual_seed(seed), cfg,
                        torch.as_tensor(x_pool, device=device), params=bpnn_params)
    bp_auc = bpnn_auc(params, cfg, sc.x_eval, sc.y_eval)
    bp_wall = time.perf_counter() - t0

    # ---- BP-NN3-FL at matched rounds: the AUC comparison trains once at
    # the grid's largest merge count; each topology's comm ratio prices
    # FedAvg at that topology's own admitted merge count
    rounds = max(1, max(rows[t]["merges"] for t in topologies))
    t0 = time.perf_counter()
    fa_params = run_fedavg(torch.Generator().manual_seed(seed + 1), cfg, per_device,
                           FedAvgConfig(rounds=rounds, local_epochs=1), device=device,
                           params=fedavg_params)
    fa_auc = bpnn_auc(fa_params, cfg, sc.x_eval, sc.y_eval)
    fa_wall = time.perf_counter() - t0
    fa_bytes = fedavg_total_cost(
        spec.n_devices, rounds, sc.n_features, BPNN_HIDDEN, sc.n_features).bytes_total
    for topo in topologies:
        r = rows[topo]
        matched = fedavg_total_cost(spec.n_devices, max(r["merges"], 1), sc.n_features,
                                    BPNN_HIDDEN, sc.n_features).bytes_total
        r["fedavg_bytes_matched"] = matched
        r["comm_ratio_vs_fedavg"] = matched / max(r["comm_bytes"], 1)

    return {
        "scenario": name,
        "n_devices": spec.n_devices,
        "ticks": spec.ticks,
        "n_features": sc.n_features,
        "n_hidden": spec.n_hidden,
        "payload_precision": payload_precision,
        "topologies": rows,
        "bpnn": {"auc": bp_auc, "hidden": BPNN_HIDDEN, "epochs": BPNN_EPOCHS,
                 "wall_seconds": bp_wall},
        "fedavg": {"auc": fa_auc, "rounds": rounds, "bytes": fa_bytes, "wall_seconds": fa_wall},
    }


def check_claims(report: dict, topologies: tuple[str, ...], *,
                 comm_factor: float = COMM_FACTOR) -> dict:
    """The mechanical form of the paper's headline claims, as the
    reference's ``check_claims``, plus ``kernels_launched``: every kernel
    each run routes to was launched (None for a CPU run, which launches
    none)."""
    asserted = [t for t in topologies if t not in UNASSERTED_TOPOLOGIES]
    green = {}
    matches = []
    launched = []
    for name, row in report["scenarios"].items():
        for topo, r in row["topologies"].items():
            green[f"{name}/{topo}"] = bool(
                r["merges"] >= 1
                and np.isfinite(r["merged_auc_mean"])
                and np.isfinite(r["local_auc_mean"])
            )
            if r["launches"] is not None:
                launched.append(all(n > 0 for n in r["launches"].values()))
        bp = row["bpnn"]["auc"]
        near_bp = all(row["topologies"][t]["clean_merged_auc_mean"] >= bp - AUC_MARGIN
                      for t in asserted)
        cheap = all(row["topologies"][t]["comm_ratio_vs_fedavg"] >= comm_factor
                    for t in asserted)
        if near_bp and cheap:
            matches.append(name)
    return {
        "all_green": all(green.values()),
        "green": green,
        "auc_and_comm_scenarios": matches,
        "kernels_launched": all(launched) if launched else None,
    }


def run_bench(*, smoke: bool = True, seed: int = 0, payload_precision: str = "f32",
              device: str | torch.device | None = None) -> dict:
    device = resolve_device(device)
    sizes = SMOKE_SIZES if smoke else FULL_SIZES
    topologies = SMOKE_TOPOLOGIES if smoke else FULL_TOPOLOGIES
    comm_factor = COMM_FACTOR_BY_PRECISION[payload_precision]
    scenarios = {
        name: eval_scenario(name, sizes, topologies, seed=seed,
                            payload_precision=payload_precision, device=device)
        # fault-carrying presets ("adversarial") are the robust benchmark's:
        # this grid is the clean paper comparison
        for name in sorted(SCENARIOS)
        if not SCENARIOS[name]().faults
    }
    report = {
        "backend": backend_of(device),
        "smoke": smoke,
        "merge_every": MERGE_EVERY,
        "auc_margin": AUC_MARGIN,
        "comm_factor": comm_factor,
        "payload_precision": payload_precision,
        "scenarios": scenarios,
    }
    report["claims"] = check_claims(report, topologies, comm_factor=comm_factor)
    return report


def table_lines(report: dict) -> list[str]:
    """One CSV-style line per (scenario, topology): wall µs, AUCs, merges,
    bytes, the comm ratio and the tick's p50/p99 from the sink."""
    bench = BENCH_NAMES[report["payload_precision"]]
    lines = []
    for name, row in report["scenarios"].items():
        bp, fa = row["bpnn"]["auc"], row["fedavg"]["auc"]
        for topo, r in row["topologies"].items():
            lines.append(
                f"{bench}/{name}/{topo},{r['wall_seconds'] * 1e6:.1f},"
                f"local={r['local_auc_mean']:.3f};"
                f"merged={r['merged_auc_mean']:.3f};"
                f"clean={r['clean_merged_auc_mean']:.3f};"
                f"bpnn={bp:.3f};fedavg_r{row['fedavg']['rounds']}={fa:.3f};"
                f"merges={r['merges']};"
                f"bytes={r['comm_bytes']};"
                f"bytes_per_merge={r['bytes_per_merge']:.0f};"
                f"comm_x={r['comm_ratio_vs_fedavg']:.1f};"
                f"tick_p50_us={r['tick_p50_us']:.1f};tick_p99_us={r['tick_p99_us']:.1f}"
            )
    return lines


def main(
    smoke: bool = True,
    out_path: str | None = None,
    history_path: str = "BENCH_torch_history.jsonl",
    payload_precision: str = "f32",
    device: str | torch.device | None = None,
) -> list[str]:
    quantized = payload_precision != "f32"
    out_path = PAPER_EVAL_FILES[payload_precision] if out_path is None else out_path
    report = run_bench(smoke=smoke, payload_precision=payload_precision, device=device)
    # persist before asserting: a failed claim still leaves the artifact
    with open(out_path, "w") as fh:
        json.dump(report, fh, indent=2)

    bench = BENCH_NAMES[payload_precision]
    metrics: dict[str, float] = {}
    for name, row in report["scenarios"].items():
        # gate on the per-scenario total (the runtime grid and both baselines)
        metrics[f"{name}_total_us"] = 1e6 * (
            sum(r["wall_seconds"] for r in row["topologies"].values())
            + row["bpnn"]["wall_seconds"] + row["fedavg"]["wall_seconds"])
        for topo, r in row["topologies"].items():
            metrics[f"{name}_{topo}_clean_auc"] = r["clean_merged_auc_mean"]
            if quantized:
                metrics[f"{name}_{topo}_comm_ratio"] = r["comm_ratio_vs_fedavg"]
    lines = table_lines(report)

    claims = report["claims"]
    assert claims["all_green"], claims["green"]
    assert claims["auc_and_comm_scenarios"], report["scenarios"]
    assert claims["kernels_launched"] is not False, {
        f"{n}/{t}": r["launches"] for n, row in report["scenarios"].items()
        for t, r in row["topologies"].items()}
    lines.append(
        f"# {bench} claims ok (payload={payload_precision}, comm_factor="
        f"{report['comm_factor']:g}, backend={report['backend']}, kernels launched: "
        f"{claims['kernels_launched']}) — AUC+comm scenarios: "
        f"{claims['auc_and_comm_scenarios']} → {out_path}")
    # the history gate after the claims: a wall-clock regression should not
    # mask, or be masked by, a failed claim
    record_and_gate(bench, metrics, backend=report["backend"], path=history_path,
                    threshold=0.25 if quantized else 0.5)
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke grid: all three scenarios on ring + star (the default)")
    ap.add_argument("--full", action="store_true",
                    help="the full topology grid (bigger fleets)")
    ap.add_argument("--payload-precision", default="f32", choices=("f32", "f16", "int8"),
                    help="merge-payload wire format; non-f32 raises the asserted comm bar to "
                         "the precision's (int8 ≥60×, f16 ≥10×) and writes its own artifact")
    ap.add_argument("--out", default=None, help="report path (default depends on precision)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    for line in main(smoke=not args.full, out_path=args.out,
                     payload_precision=args.payload_precision, device=args.device):
        print(line)
    print(f"# torch_paper_eval ok ({'full' if args.full else 'smoke'} grid, "
          f"payload={args.payload_precision})")
