"""Fleet-ingest benchmark on the port — the fused tick ingest against the
per-sample baseline (the PyTorch counterpart of
``benchmarks/fleet_ingest.py``), on the card.

The per-tick training hot path (``FleetRuntime.tick``'s ingest: the
pre-train ``ae_score`` drift signal, then k=1 sequential updates over the
tick's window) in three forms, at fleet scale D ∈ {256, 1024, 4096}:

- ``baseline`` — the ingest without the kernel: one scoring pass over the
  stacked fleet, then ``TICK_SAMPLES`` sequential k=1 RLS updates of the
  whole fleet (Eqs. 9–11, in the reference's order), each in batched
  library calls (``torch.bmm``/``torch.baddbmm`` over D). Every sample
  round-trips P (Ñ×Ñ) and β (Ñ×m) through HBM. It calls no hand-written
  kernel.
- ``fused`` — ``repro_torch.kernels.fleet_ingest.fleet_ingest``, the
  kernel: one pass (the projection once, the score re-used as the
  update's innovation, the k=1 chain with P and β touched once a window).
- ``plain`` — the kernel's plain PyTorch version, timed at D ≤ 256 for
  visibility only (it follows the kernel's chunked order).

Asserted, as the reference asserts:
  - the fused ingest (and, at D ≤ 256, the plain version) agrees with the
    baseline: β at rtol 1e-4 / atol 1e-5, the losses at 1e-5 / 1e-7; at
    D ≤ 256 the kernel also agrees with its plain version within 1e-4 of
    each output's largest value;
  - the fused ingest beats the baseline on the card's clock at
    D ≥ 1024 (a CPU rehearsal times the kernel's plain version, so there
    the comparison is reported, not asserted);
  - accounting: the fused path moves T× less per-tick state traffic (P/β
    touched once per window, not once per sample).

Each form is timed twice on the card: by CUDA events around a call
(``*_us``, host enqueue gaps included: the baseline's ~350 small launches
make it mostly host time) and by its device time (``*_device_us``, the
sum of the durations of what the call ran on the card, the median over
five profiled sessions of ten calls: ``torch_device_time.device_us``).

Writes ``BENCH_torch_fleet_ingest.json`` and appends the run to
``BENCH_torch_history.jsonl`` (``benchmarks/torch_history.py``, keyed by
the card's name): on the card the device times, as
``fused_d{D}_device_us`` and ``baseline_d{D}_device_us``; on the CPU the
host-clock times as ``*_host_ms``, which no gate reads. Standalone runs
also gate: a device time more than 25 % over the previous baseline of the
same card fails the run (the first run seeds it). The events times are
reported, not gated: back-to-back runs of one tree moved them by up to
92 %. Under ``benchmarks/torch_run.py`` the gate is the harness's
``--check-regression`` instead.

    python benchmarks/torch_fleet_ingest.py [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.torch_device_time import device_us  # noqa: E402
from benchmarks.torch_common import bench_device, timed_ms, where_line  # noqa: E402
from benchmarks.torch_history import backend_of, record, record_and_gate  # noqa: E402
from repro_torch.core import get_activation  # noqa: E402
from repro_torch.fleet import init_fleet  # noqa: E402
from repro_torch.kernels.fleet_ingest import fleet_ingest, fleet_ingest_plain  # noqa: E402

INGEST_GRID = (256, 1024, 4096)     # the D sweep
INGEST_GRID_SMOKE = (256, 1024)     # the smoke still covers the asserted D=1024 win
N_HIDDEN = 32                       # the runtime soak's width (serve_runtime.py)
N_FEATURES = 64
TICK_SAMPLES = 32                   # per-device window per tick
PLAIN_LIMIT = 256                   # the plain version is timed up to here (visibility only)
ASSERT_AT = 1024                    # fused must beat baseline from here up
KERNEL_PLAIN_TOL = 1e-4             # chip_smoke.py's bound for the ingest kernel


def make_fleet(n_dev: int, seed: int = 0, device=None):
    """A fleet of ``n_dev`` autoencoders (one basis, each booted on its own
    uniform chunk) and one tick's uniform window, from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    x_init = torch.rand((n_dev, 2 * N_HIDDEN, N_FEATURES), generator=g)
    fleet = init_fleet(g, n_dev, N_FEATURES, N_HIDDEN, x_init,
                       activation="identity", ridge=1e-3, device=device)
    window = torch.rand((n_dev, TICK_SAMPLES, N_FEATURES),
                        generator=torch.Generator().manual_seed(seed + 1))
    return fleet, window.to(fleet.device)


def baseline_ingest(fleet, window: torch.Tensor):
    """The ingest without the kernel: a scoring pass, then one k=1 RLS
    update of every device a sample (Eqs. 9–11 as the reference's
    ``oselm_step_k1`` orders them), in batched library calls.
    Returns (trained fleet, (D,) mean pre-train loss)."""
    g = get_activation(fleet.activation)
    alpha, bias = fleet.params
    d, t, n = window.shape
    h_all = g(torch.addmm(bias, window.reshape(d * t, n), alpha)).reshape(d, t, -1)
    y = torch.bmm(h_all, fleet.beta)
    losses = torch.mean(torch.mean((window - y) ** 2, dim=-1), dim=-1)
    p, beta = fleet.p, fleet.beta
    for s in range(t):
        x = window[:, s]
        h = g(torch.addmm(bias, x, alpha))[:, :, None]             # (D, Ñ, 1)
        p = p / fleet.forget
        ph = torch.bmm(p, h)
        denom = 1.0 + torch.bmm(h.transpose(1, 2), ph)              # (D, 1, 1)
        p = p - torch.bmm(ph, ph.transpose(1, 2)) / denom
        err = x[:, None, :] - torch.bmm(h.transpose(1, 2), beta)    # (D, 1, m)
        beta = torch.baddbmm(beta, torch.bmm(p, h), err)
    return fleet.replace(p=p, beta=beta), losses


def _agree(states, losses, base_states, base_losses) -> None:
    np.testing.assert_allclose(states.beta.cpu().numpy(), base_states.beta.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(losses.cpu().numpy(), base_losses.cpu().numpy(),
                               rtol=1e-5, atol=1e-7)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _state_traffic_bytes(n_dev: int, per_sample: bool) -> int:
    """Per-tick HBM traffic of the (P, β) state: read + write, once per
    sample for the baseline against once per window for the fused path."""
    floats = N_HIDDEN * N_HIDDEN + N_HIDDEN * N_FEATURES  # P + β per device
    touches = TICK_SAMPLES if per_sample else 1
    return 2 * 4 * n_dev * floats * touches


def run_bench(device_grid: tuple[int, ...] = INGEST_GRID, seed: int = 0, *, device=None,
              fleet_maker=make_fleet) -> dict:
    """The grid's rows. ``fleet_maker(n_dev, seed, device)`` returns a
    (fleet, window) pair, as ``make_fleet`` does."""
    device = bench_device(device)
    rows = []
    for n_dev in device_grid:
        fleet, window = fleet_maker(n_dev, seed, device)

        base_states, base_losses = baseline_ingest(fleet, window)
        fused_states, fused_losses = fleet_ingest(fleet, window)
        # every form agrees with the sequential baseline
        _agree(fused_states, fused_losses, base_states, base_losses)

        base_us = 1e3 * timed_ms(lambda: baseline_ingest(fleet, window), device,
                                 warmup=1, iters=5)
        fused_us = 1e3 * timed_ms(lambda: fleet_ingest(fleet, window), device,
                                  warmup=1, iters=5)
        on_card = device.type == "cuda"
        base_dev = device_us(lambda: baseline_ingest(fleet, window)) if on_card else None
        fused_dev = device_us(lambda: fleet_ingest(fleet, window)) if on_card else None

        plain_us = kernel_rel = None
        if n_dev <= PLAIN_LIMIT:
            pl_states, pl_losses = fleet_ingest_plain(fleet, window)
            _agree(pl_states, pl_losses, base_states, base_losses)
            kernel_rel = max(_rel(fused_states.p, pl_states.p),
                             _rel(fused_states.beta, pl_states.beta),
                             _rel(fused_losses, pl_losses))
            assert kernel_rel <= KERNEL_PLAIN_TOL, (
                f"D={n_dev}: fleet_ingest disagrees with its plain version ({kernel_rel:.3e})")
            plain_us = 1e3 * timed_ms(lambda: fleet_ingest_plain(fleet, window), device,
                                      warmup=1, iters=3)

        samples = n_dev * TICK_SAMPLES
        rows.append({
            "n_devices": n_dev,
            "tick_samples": TICK_SAMPLES,
            "baseline_us": base_us,
            "fused_us": fused_us,
            "baseline_device_us": base_dev,
            "fused_device_us": fused_dev,
            "plain_us": plain_us,
            "kernel_plain_rel": kernel_rel,
            "speedup": base_us / fused_us,
            "samples_per_sec_baseline": samples / (base_us * 1e-6),
            "samples_per_sec_fused": samples / (fused_us * 1e-6),
            "samples_per_sec_per_device_fused": TICK_SAMPLES / (fused_us * 1e-6),
            "state_bytes_baseline": _state_traffic_bytes(n_dev, per_sample=True),
            "state_bytes_fused": _state_traffic_bytes(n_dev, per_sample=False),
        })
    return {
        "n_hidden": N_HIDDEN,
        "n_features": N_FEATURES,
        "tick_samples": TICK_SAMPLES,
        "backend": backend_of(device),
        "device_grid": list(device_grid),
        "rows": rows,
    }


def report_lines(
    device_grid: tuple[int, ...] = INGEST_GRID,
    out_path: str = "BENCH_torch_fleet_ingest.json",
    history_path: str = "BENCH_torch_history.jsonl",
    gate: bool = False,
    *,
    device=None,
) -> list[str]:
    """Run the grid, write the report and the history, assert the claims."""
    device = bench_device(device)
    report = run_bench(device_grid=device_grid, device=device)
    # persist the measurements BEFORE asserting on them, so a perf
    # regression still leaves the artifact needed to debug it
    with open(out_path, "w") as fh:
        json.dump(report, fh, indent=2)
    on_card = device.type == "cuda"
    lines = []
    metrics: dict[str, float] = {}
    for r in report["rows"]:
        d = r["n_devices"]
        plain = f"{r['plain_us']:.1f}" if r["plain_us"] else "n/a"
        dev = (f"fused_device_us={r['fused_device_us']:.1f};"
               f"baseline_device_us={r['baseline_device_us']:.1f};" if on_card else "")
        lines.append(
            f"fleet_ingest/d{d},"
            f"{r['fused_us']:.1f},"
            f"baseline_us={r['baseline_us']:.1f};speedup={r['speedup']:.2f};{dev}"
            f"samples_per_sec={r['samples_per_sec_fused']:.0f};"
            f"plain_us={plain};"
            f"state_bytes_ratio={r['state_bytes_baseline'] / r['state_bytes_fused']:.0f}"
        )
        # the gated numbers: the card's device time, which the code sets;
        # the CPU's host clock is recorded under keys no gate reads
        if on_card:
            metrics[f"fused_d{d}_device_us"] = r["fused_device_us"]
            metrics[f"baseline_d{d}_device_us"] = r["baseline_device_us"]
        else:
            metrics[f"fused_d{d}_host_ms"] = r["fused_us"] / 1e3
            metrics[f"baseline_d{d}_host_ms"] = r["baseline_us"] / 1e3
        # fused state traffic is T× lighter by construction at every size
        assert r["state_bytes_fused"] < r["state_bytes_baseline"], r
        # ...and the kernel must win on the card's clock at scale
        if on_card and d >= ASSERT_AT:
            assert r["fused_us"] < r["baseline_us"], r
    # trajectory: append this run; standalone invocations gate on a >25 %
    # device-time regression against the previous baseline of the same card
    # (the first run seeds it), while torch_run.py records only — its gate
    # is the opt-in --check-regression flag
    if gate:
        record_and_gate("torch_fleet_ingest", metrics, backend=report["backend"],
                        path=history_path)
    else:
        record("torch_fleet_ingest", metrics, backend=report["backend"], path=history_path)
    lines.append(f"# ingest-bench artifact → {out_path} (history → {history_path}); fused <"
                 f" baseline at D ≥ {ASSERT_AT} "
                 + ("asserted" if on_card else "not asserted on the host clock"))
    return lines


def main(argv=None, *, gate: bool = False) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="smaller grid (D ≤ 1024); still asserts the D=1024 win on the card")
    ap.add_argument("--out", default="BENCH_torch_fleet_ingest.json")
    ap.add_argument("--history", default="BENCH_torch_history.jsonl")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = bench_device(args.device)
    grid = INGEST_GRID_SMOKE if args.smoke else INGEST_GRID
    return report_lines(grid, args.out, args.history, gate, device=device) + [
        f"# fleet_ingest ok — grid {grid}", f"# torch_fleet_ingest on {where_line(device)}"]


if __name__ == "__main__":
    for line in main(gate=True):
        print(line)
