"""Reproduce the paper's headline comparison as a readable table, on the
PyTorch/CUDA port.

Runs each paper-analog scenario (driving / har / mnist_like) end to end
through the resident ``FleetRuntime`` on ring and star topologies, then
prints the §5-style comparison: per-device (local) AUC before any
cooperation, post-merge AUC, the BP-NN3 centralized baseline, FedAvg at
matched rounds, the communication-bytes ratio, and the tick's p50 from
the runtime's telemetry.

    python examples/torch_paper_tables.py [--scenario har] [--device cpu]

It runs on the CUDA card by default; ``--device cpu`` runs the kernels'
plain PyTorch versions instead (host-clock times, not the card's).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from benchmarks.torch_paper_eval import SMOKE_SIZES, SMOKE_TOPOLOGIES, eval_scenario  # noqa: E402
from repro_torch.scenarios import SCENARIOS  # noqa: E402


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default=None, choices=sorted(SCENARIOS))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    names = [args.scenario] if args.scenario else sorted(SCENARIOS)

    hdr = (f"{'scenario':<12} {'topology':<8} {'local':>6} {'merged':>6} {'clean':>6} "
           f"{'BP-NN3':>6} {'FedAvg':>6} {'comm×':>6} {'delay':>6} {'tick p50 ms':>11}")
    print(hdr)
    print("-" * len(hdr))
    for name in names:
        row = eval_scenario(name, SMOKE_SIZES, SMOKE_TOPOLOGIES, device=args.device)
        bp, fa = row["bpnn"]["auc"], row["fedavg"]["auc"]
        for topo, r in row["topologies"].items():
            delay = r["detection_delay_mean"]
            print(
                f"{name:<12} {topo:<8} {r['local_auc_mean']:>6.3f} "
                f"{r['merged_auc_mean']:>6.3f} {r['clean_merged_auc_mean']:>6.3f} "
                f"{bp:>6.3f} {fa:>6.3f} {r['comm_ratio_vs_fedavg']:>6.1f} "
                f"{'-' if delay is None else f'{delay:.1f}':>6} {r['tick_p50_us'] / 1e3:>11.2f}"
            )
        print(f"  ({row['n_devices']} devices × {row['ticks']} ticks, "
              f"FedAvg R={row['fedavg']['rounds']} matched to the runtime's merges; "
              f"'clean' = devices that never drifted)")


if __name__ == "__main__":
    main()
