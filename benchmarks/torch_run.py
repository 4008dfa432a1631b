"""Benchmark harness of the port — one entry per paper table or figure and
per fleet-scale claim (the PyTorch counterpart of ``benchmarks/run.py``),
on the card.

Prints ``name,us_per_call,derived`` CSV lines. Each module also asserts
the paper's qualitative claims mechanically (a failed claim fails the
harness). Every run's per-benchmark summary (each line's µs) is appended
to ``BENCH_torch_history.jsonl`` under ``run.<name>``
(``benchmarks/torch_history.py``, keyed by the card's name); pass
``--check-regression`` to fail any benchmark whose timings got more than
25 % slower than its previous entry on the same card (the first run of a
benchmark seeds its baseline).

    python benchmarks/torch_run.py [--only NAME] [--check-regression] [--device cpu]

Reference benchmarks not yet ported: none. The last of them,
``torch_roofline_report``, renders the dry run's records (``python -m
repro_torch.launch.dryrun``), which need no card.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.torch_common import bench_device  # noqa: E402
from benchmarks.torch_history import backend_of, check_regression, record  # noqa: E402

BENCHES = [
    ("torch_merge_loss", "paper Fig. 6/7 — loss before/after cooperative update"),
    ("torch_rocauc_grid", "paper Figs. 8-17 — ROC-AUC vs BP-NN baselines"),
    ("torch_latency", "paper Table 4 — train/predict/merge latencies"),
    ("torch_convergence", "paper Fig. 18 — merge vs sequential training"),
    ("torch_fleet_scale", "ours — fleet simulator: devices × topology grid"),
    ("torch_paper_eval", "paper §5 — scenario grid vs BP-NN / FedAvg at matched rounds"),
    ("torch_fleet_ingest", "ours — fused tick ingest vs per-sample baseline"),
    ("torch_fleet_cohort", "ours — cohort-paged arena runtime at 10^5-10^6 devices"),
    ("torch_kernel_bench", "ours — CUDA kernel micro-bench against library calls"),
    ("torch_ablation_hidden", "ours — detector width ablation (accuracy vs payload)"),
    ("torch_robust_fleet", "ours — Byzantine-robust merges + fault-injection chaos soak"),
    ("torch_serve_runtime", "ours — resident serve-runtime soak: drift gating, SLO, int8"),
    ("torch_serve_ingress", "ours — async ingress front-end: load, flood, crash, degraded"),
    ("torch_mesh_merge", "ours — cooperative update as one all-reduce pair across ranks"),
    ("torch_roofline_report", "ours — roofline table from the dry-run records"),
]


def _line_metrics(lines: list[str]) -> dict[str, float]:
    """us_per_call per CSV line, keyed ``<line name>_us`` — the
    wall-clock summary the history trajectory tracks."""
    metrics: dict[str, float] = {}
    for line in lines:
        parts = line.split(",")
        if len(parts) < 2 or line.startswith("#"):
            continue
        try:
            us = float(parts[1])
        except ValueError:
            continue
        if us == us:  # NaN entries (accounting-only rows) don't gate
            metrics[f"{parts[0]}_us"] = us
    return metrics


def _run_main(mod, device: str | None) -> list[str]:
    """A benchmark's ``main`` on ``device``: the command-line style
    (``main(argv)``) or the keyword style (``main(device=...)``)."""
    if "argv" in inspect.signature(mod.main).parameters:
        return list(mod.main([] if device is None else ["--device", device]))
    return list(mod.main(device=device))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None)
    ap.add_argument("--history", default="BENCH_torch_history.jsonl")
    ap.add_argument(
        "--check-regression", action="store_true",
        help="fail a benchmark whose wall-clock regressed >25%% vs its "
             "previous history entry on the same card",
    )
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    names = [name for name, _ in BENCHES]
    if args.only and args.only not in names:
        # a typo'd --only would filter everything out and exit 0 — a
        # "green" run that measured nothing
        ap.error(
            f"--only {args.only!r}: unknown benchmark "
            f"(choose from: {', '.join(names)})"
        )
    backend = backend_of(bench_device(args.device))

    print("name,us_per_call,derived")
    failures = []
    for mod_name, desc in BENCHES:
        if args.only and args.only != mod_name:
            continue
        t0 = time.time()
        try:
            mod = importlib.import_module(f"benchmarks.{mod_name}")
            lines = _run_main(mod, args.device)
            for line in lines:
                print(line, flush=True)
            metrics = _line_metrics(lines)
            # seconds key: informational, not regression-gated (only *_us
            # keys gate; the harness's wall time includes the kernel build)
            metrics["harness_wall_seconds"] = time.time() - t0
            # the "run." namespace keeps harness summaries apart from a
            # module's own richer history entries (e.g. torch_fleet_ingest)
            prev = record(f"run.{mod_name}", metrics, backend=backend, path=args.history)
            if args.check_regression:
                regressions = check_regression(prev, metrics)
                if regressions:
                    raise AssertionError(
                        f"{mod_name} wall-clock regression: " + "; ".join(regressions)
                    )
            print(f"# {mod_name} ok in {time.time() - t0:.1f}s — {desc}", flush=True)
        except Exception:
            traceback.print_exc()
            failures.append(mod_name)
            print(f"# {mod_name} FAILED — {desc}", flush=True)
    if failures:
        print(f"# FAILURES: {failures}")
        sys.exit(1)


if __name__ == "__main__":
    main()
