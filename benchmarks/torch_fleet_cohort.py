"""Cohort-paged fleet benchmark on the port — the million-device arena
runtime (the PyTorch counterpart of ``benchmarks/fleet_cohort.py``), on the
card.

It drives ``repro_torch.runtime.CohortFleetRuntime``: each device's (P, β)
in a host ``FleetArena`` (pinned), cohorts of 16 384 devices streamed
through the fused ingest with the next page's copy in flight, and Eq. 8 as
the two-tier tree (a masked segment sum a page, an O(cohorts) fold, one
solve). Measured at D = 131 072 (``--smoke``, the default) and
D = 1 048 576 (``--full`` adds it), Ñ = 4, n = 8, B = 4: the paper's small
on-device autoencoder at fleet scale. ``--device cpu`` rehearses the same
claims at D = 4096 in cohorts of 1024 on the plain versions.

Asserted claims, as the reference asserts them:
  - correctness first: at D = 64 (cohorts of 16) the paged runtime's
    reports (flags, decisions; losses at rtol 1e-5 up to the first merge,
    2e-4 after) match the resident ``FleetRuntime``'s tick by tick on the
    same device, and one two-tier round over the same state agrees with the
    flat merge: its sums within 1e-5 relative, its β within 1e-5 or, where
    the merge's own Gauss-Jordan rounding is larger (the reference's 1e-5
    is stated for its Cholesky solve), within twice the flat round's f32
    solve's distance from an f64 solve of the same sums
    (``solve_spread``), printed;
  - the launch check (the port's compile-once): one kernel-library load,
    ``fleet_ingest`` once per page a tick, ``masked_segment_sum_mix`` once
    per page and ``from_uv_solve`` once a round (on the card; the plain
    versions count nothing);
  - tier-2 traffic is O(cohorts), not O(devices): the star round's overlay
    ships 2·(cohorts − 1) payloads, under 1/100 of the flat round's bytes.

Reported per scale point: the paged tick (best of 4, host clock to a
synchronize), devices a second through ingest, the two-tier merge (best
of 3), the bytes a round by tier, and on the card the tick's and the
merge's device time (``torch_device_time.device_us``: kernels and copies)
and the copies' time in and out a tick beside the ingest's, with the share
of the copies the overlap hid. Writes ``BENCH_torch_fleet_cohort.json`` and
appends to ``BENCH_torch_history.jsonl``: on the card the device times
(``paged_tick_d{D}_device_us``, ``two_tier_merge_d{D}_device_us``), on the
CPU the host times as ``*_host_ms``, which no gate reads, and the tier-2
reduction (``tier2_reduction_d{D}_ratio``) on both. Standalone runs gate a
device time 25 % over, or a reduction 25 % under, the previous entry of the
same card.

    python benchmarks/torch_fleet_cohort.py [--smoke | --full] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.torch_common import bench_device, routed_launches, where_line  # noqa: E402
from benchmarks.torch_device_time import device_us  # noqa: E402
from benchmarks.torch_history import backend_of, record, record_and_gate  # noqa: E402
from repro_torch.fleet import (  # noqa: E402
    FleetArena,
    cohort_round_cost,
    cohort_tree_reduce,
    fleet_merge_masked_kernel,
    fleet_to_uv,
    init_arena,
    init_fleet,
    star,
)
from repro_torch.kernels import (  # noqa: E402
    from_uv_solve,
    masked_segment_sum_mix,
    reset_launch_counts,
)
from repro_torch.runtime import (  # noqa: E402
    CohortFleetRuntime,
    DetectorConfig,
    FleetRuntime,
    GovernorConfig,
    RuntimeConfig,
)

N_HIDDEN = 4          # the paper's on-device autoencoder is small: the
N_FEATURES = 8        # point of arena scale is D, not width
BATCH = 4             # samples a device a tick
N_INIT = 16           # Eq. 13 boot chunk a device
COHORT = 16384        # a page: 16 384 devices, 3 MB of (P, β)
SMOKE_D = 131072      # 2^17, past 10^5 devices
FULL_D = 1048576      # 2^20, the million-device point
CPU_D, CPU_COHORT = 4096, 1024   # the CPU rehearsal's fleet and page
TIMED_TICKS = 4
TIMED_MERGES = 3
PARITY_D, PARITY_C, PARITY_TICKS = 64, 16, 8
RIDGE = 1e-2


def _paged_config(d: int) -> RuntimeConfig:
    return RuntimeConfig(topology=star(d), ridge=RIDGE,
                         detector=DetectorConfig(warmup=4, warmup_skip=1),
                         governor=GovernorConfig(merge_every=4))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def star_sums(states, ridge: float, cohort: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The full star round's summed payloads [ΣU | ΣV] two ways: flat, in
    device order (``masked_segment_sum_mix`` over the fleet), and as the
    two-tier merge adds them (a sum a page, then ``cohort_tree_reduce``)."""
    uv = fleet_to_uv(states, ridge=ridge)
    w = torch.cat([uv.u, uv.v], dim=2)
    d = w.shape[0]
    ones = torch.ones(d, device=w.device)
    flat = masked_segment_sum_mix(w, np.zeros(d, np.int32), ones, 1)[0]
    parts = [masked_segment_sum_mix(w[lo:lo + cohort], np.zeros(cohort, np.int32),
                                    ones[lo:lo + cohort], 1)[0] for lo in range(0, d, cohort)]
    return flat, cohort_tree_reduce(torch.stack(parts))


def solve_spread(total: torch.Tensor, ridge: float) -> float:
    """How far the f32 solve of a round's sums [ΣU | ΣV] sits from an f64
    solve of the same sums (max |β| difference): the rounding of the
    Gauss-Jordan elimination itself. Its pivot-row update, w − (w_kk − 1)·
    row_k (the reference kernel's ``_gj_sweep``), carries row_k's rounding
    times |w_kk|, so a round whose summed U is large moves β by that much
    whatever order the sums were added in."""
    nh = total.shape[0]
    _, beta = from_uv_solve(total[None, :, :nh], total[None, :, nh:], ridge=ridge)
    a = total[:, :nh].double() + ridge * torch.eye(nh, dtype=torch.float64, device=total.device)
    exact = torch.linalg.solve(a, total[:, nh:].double())
    return float((beta[0].double() - exact).abs().max())


def check_parity(device: torch.device, seed: int = 0) -> dict[str, float]:
    """Paged against resident at D = 64 on ``device``: the same flags and
    decisions tick by tick, losses at rtol 1e-5 up to the first merge and
    at the resident runtime's 2e-4 after; then one two-tier round against
    one flat round over the resident fleet's state: their sums within 1e-5
    of the largest (f32 adds of 64 payloads in two orders: the tree only
    reorders them), β within the larger of 1e-5 and twice the flat solve's
    own spread (``solve_spread``), as is the paged fleet's β after the run
    (there the reference's 5e-5 the floor)."""
    d, c = PARITY_D, PARITY_C
    g = torch.Generator().manual_seed(seed)
    x0 = torch.randn((d, N_INIT, N_FEATURES), generator=g) * 0.5
    states = init_fleet(g, d, N_FEATURES, N_HIDDEN, x0, ridge=RIDGE, device=device)
    cfg = _paged_config(d)
    resident = FleetRuntime(states, cfg, device=device)
    paged = CohortFleetRuntime(FleetArena.from_fleet(states), cfg, cohort_size=c, device=device)
    rng = np.random.default_rng(seed + 2)
    merged, worst = False, 0.0
    for t in range(PARITY_TICKS):
        batch = rng.normal(scale=0.5, size=(d, BATCH, N_FEATURES)).astype(np.float32)
        r1, r2 = resident.tick(batch), paged.tick(batch)
        np.testing.assert_allclose(r2.losses, r1.losses, rtol=2e-4 if merged else 1e-5,
                                   atol=1e-6)
        worst = max(worst, float(np.max(np.abs(r2.losses - r1.losses) / np.abs(r1.losses))))
        assert np.array_equal(r1.drifted, r2.drifted), t
        d1, d2 = r1.decision, r2.decision
        assert (d1.merge, d1.reason, d1.participants, d1.round_bytes) == (
            d2.merge, d2.reason, d2.participants, d2.round_bytes), (t, d1, d2)
        merged |= d1.merge
    assert merged, "the parity run never merged"
    flat_sum, tree_sum = star_sums(resident.states, cfg.ridge, c)
    sums_rel = float((tree_sum - flat_sum).abs().max() / flat_sum.abs().max())
    assert sums_rel <= 1e-5, f"the tree's sums left the flat sums: {sums_rel}"
    spread = solve_spread(flat_sum, cfg.ridge)
    e2e = float((resident.states.beta.cpu() - paged.arena.beta).abs().max())
    # one two-tier round and one flat round over the same state
    arena = FleetArena.from_fleet(resident.states)
    ones = np.ones(d, bool)
    paged.merger.merge(arena, ones)
    flat = fleet_merge_masked_kernel(resident.states, cfg.topology,
                                     torch.ones(d, device=device), ridge=cfg.ridge)
    gap = float((flat.beta.cpu() - arena.beta).abs().max())
    bound = max(1e-5, 2 * spread)
    assert gap <= bound, f"two-tier merge diverged from the flat merge: {gap} > {bound}"
    assert e2e <= max(5e-5, 2 * spread), f"paged runtime drifted from resident: {e2e}"
    return {"beta_gap": gap, "bound": bound, "solve_spread": spread, "e2e_beta": e2e,
            "losses_rel": worst, "sums_rel": sums_rel}


def run_scale(n_devices: int, cohort: int, device: torch.device, seed: int = 0) -> dict:
    """The paged runtime at scale: ingest ticks and two-tier merge rounds
    over a host arena that never exists as a stacked fleet."""
    cohort = min(cohort, n_devices)
    start = time.perf_counter()
    rng = np.random.default_rng(seed)
    boot = rng.normal(scale=0.5, size=(cohort, N_INIT, N_FEATURES)).astype(np.float32)
    t0 = time.perf_counter()
    arena = init_arena(torch.Generator().manual_seed(seed), n_devices, N_FEATURES, N_HIDDEN,
                       lambda lo, hi: boot[: hi - lo], cohort_size=cohort, ridge=RIDGE,
                       device=device)
    init_seconds = time.perf_counter() - t0

    cfg = _paged_config(n_devices)
    t0 = time.perf_counter()
    rt = CohortFleetRuntime(arena, cfg, cohort_size=cohort, device=device)
    rt.warmup(BATCH)
    build_seconds = time.perf_counter() - t0
    window = rng.normal(scale=0.5, size=(cohort, BATCH, N_FEATURES)).astype(np.float32)

    def batch_fn(lo, hi):
        return window[: hi - lo]

    reset_launch_counts()
    rt.tick(batch_fn, allow_merge=False)
    # best-of floors: a shared host's load moves a single run's wall clock
    tick_us, paging = [], []
    for _ in range(TIMED_TICKS):
        t0 = time.perf_counter()
        rt.tick(batch_fn, allow_merge=False)
        tick_us.append((time.perf_counter() - t0) * 1e6)
        paging.append(rt.last_paging)
    ones = np.ones(n_devices, bool)
    merge_us = []
    for _ in range(TIMED_MERGES):
        t0 = time.perf_counter()
        cost = rt.merger.merge(arena, ones)
        _sync(device)
        merge_us.append((time.perf_counter() - t0) * 1e6)
    merge_paging = rt.merger._pager.times()
    nc = rt.schedule.n_cohorts
    launches = routed_launches(device, {
        "fleet_ingest": nc * (1 + TIMED_TICKS),
        "masked_segment_sum_mix": nc * TIMED_MERGES,
        "from_uv_solve": TIMED_MERGES,
    })
    rt.assert_compile_once()

    tick_dev = merge_dev = None
    t0 = time.perf_counter()
    if device.type == "cuda":
        # three profiled sessions of one call each (the tick and the merge
        # are warm): at a million devices a session sees ~1 000 launches
        # and copies a call, and its processing, not the card, takes the time
        tick_dev = device_us(lambda: rt.tick(batch_fn, allow_merge=False),
                             warmup=0, calls=1, sessions=3)
        merge_dev = device_us(lambda: rt.merger.merge(arena, ones), warmup=0, calls=1,
                              sessions=3)
    profile_seconds = time.perf_counter() - t0

    # the overlay (tier 2) is O(cohorts): the flat star round ships 2(D − 1)
    # payloads, the two-tier round's overlay 2(cohorts − 1)
    acct = cohort_round_cost(cfg.topology, rt.schedule, N_HIDDEN, N_FEATURES)
    assert acct.tier2_payloads <= 2 * nc, acct
    flat_payloads = cfg.topology.payloads_per_round
    best = int(np.argmin(tick_us))
    page = paging[best]
    copies = page["in_s"] + page["out_s"]
    # the share of the copies' time the overlap hid: copies and compute side
    # by side on the card's streams against the span from first copy to last
    hidden = ((copies + page["compute_s"] - page["span_s"]) / copies
              if device.type == "cuda" and copies else None)
    return {
        "n_devices": n_devices,
        "cohort_size": cohort,
        "n_cohorts": nc,
        "batch": BATCH,
        "arena_mb": arena.nbytes / 2**20,
        "init_seconds": init_seconds,
        "build_seconds": build_seconds,
        "tick_us": tick_us[best],
        "tick_device_us": tick_dev,
        "page_in_ms": page["in_s"] * 1e3,
        "page_out_ms": page["out_s"] * 1e3,
        "ingest_ms": page["compute_s"] * 1e3,
        "paging_span_ms": page["span_s"] * 1e3,
        "copy_hidden_share": hidden,
        "devices_per_sec": n_devices / (tick_us[best] * 1e-6),
        "samples_per_sec": n_devices * BATCH / (tick_us[best] * 1e-6),
        "merge_us": float(np.min(merge_us)),
        "merge_device_us": merge_dev,
        "merge_page_in_ms": merge_paging["in_s"] * 1e3 / TIMED_MERGES,
        "merge_page_out_ms": merge_paging["out_s"] * 1e3 / TIMED_MERGES,
        "launches": launches,
        "tier1_bytes_per_round": cost.bytes_tier1,
        "tier2_bytes_per_round": cost.bytes_tier2,
        "flat_bytes_per_round": flat_payloads * acct.payload_bytes,
        "tier2_reduction": flat_payloads / max(acct.tier2_payloads, 1),
        "seconds": time.perf_counter() - start,
        "profile_seconds": profile_seconds,
    }


def report_lines(
    device_grid: tuple[int, ...],
    out_path: str = "BENCH_torch_fleet_cohort.json",
    history_path: str = "BENCH_torch_history.jsonl",
    gate: bool = False,
    *,
    device=None,
    cohort: int = COHORT,
) -> list[str]:
    """Run the parity check and the grid, write the report and the
    history, assert the claims."""
    device = bench_device(device)
    parity = check_parity(device)
    rows = [run_scale(d, cohort, device) for d in device_grid]
    report = {
        "n_hidden": N_HIDDEN, "n_features": N_FEATURES, "batch": BATCH,
        "backend": backend_of(device), "parity": parity, "rows": rows,
    }
    with open(out_path, "w") as fh:
        json.dump(report, fh, indent=2)
    on_card = device.type == "cuda"
    lines = [f"fleet_cohort/parity_d{PARITY_D},nan,max_beta_gap={parity['beta_gap']:.2e};"
             f"bound={parity['bound']:.2e};solve_spread={parity['solve_spread']:.2e};"
             f"e2e_beta={parity['e2e_beta']:.2e};losses_rel={parity['losses_rel']:.2e};"
             f"sums_rel={parity['sums_rel']:.2e}"]
    metrics: dict[str, float] = {}
    for r in rows:
        d = r["n_devices"]
        hidden = "n/a" if r["copy_hidden_share"] is None else f"{r['copy_hidden_share']:.2f}"
        dev = (f"tick_device_us={r['tick_device_us']:.1f};"
               f"merge_device_us={r['merge_device_us']:.1f};" if on_card else "")
        lines.append(
            f"fleet_cohort/d{d},{r['tick_us']:.1f},"
            f"devices_per_sec={r['devices_per_sec']:.0f};arena_mb={r['arena_mb']:.0f};"
            f"merge_us={r['merge_us']:.1f};{dev}"
            f"page_in_ms={r['page_in_ms']:.3f};page_out_ms={r['page_out_ms']:.3f};"
            f"ingest_ms={r['ingest_ms']:.3f};copy_hidden={hidden};"
            f"tier1_bytes={r['tier1_bytes_per_round']};"
            f"tier2_bytes={r['tier2_bytes_per_round']};"
            f"tier2_reduction={r['tier2_reduction']:.0f}x")
        if on_card:
            metrics[f"paged_tick_d{d}_device_us"] = r["tick_device_us"]
            metrics[f"two_tier_merge_d{d}_device_us"] = r["merge_device_us"]
        else:
            metrics[f"paged_tick_d{d}_host_ms"] = r["tick_us"] / 1e3
            metrics[f"two_tier_merge_d{d}_host_ms"] = r["merge_us"] / 1e3
        metrics[f"tier2_reduction_d{d}_ratio"] = r["tier2_reduction"]
        # the overlay claim: tier 2 carries under 1/100 of the flat round
        assert r["tier2_bytes_per_round"] * 100 < r["flat_bytes_per_round"], r
    if gate:
        record_and_gate("torch_fleet_cohort", metrics, backend=report["backend"],
                        path=history_path)
    else:
        record("torch_fleet_cohort", metrics, backend=report["backend"], path=history_path)
    lines.append(f"# cohort-bench artifact → {out_path} (history → {history_path})")
    return lines


def main(argv=None, *, gate: bool = False) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="D = 131072 only (the default)")
    ap.add_argument("--full", action="store_true", help="add the million-device point")
    ap.add_argument("--out", default="BENCH_torch_fleet_cohort.json")
    ap.add_argument("--history", default="BENCH_torch_history.jsonl")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = bench_device(args.device)
    if device.type == "cpu":
        grid, cohort = (CPU_D,), CPU_COHORT
    else:
        grid, cohort = ((SMOKE_D, FULL_D) if args.full else (SMOKE_D,)), COHORT
    return report_lines(grid, args.out, args.history, gate, device=device, cohort=cohort) + [
        f"# fleet_cohort ok — grid {grid}, cohorts of {cohort}",
        f"# torch_fleet_cohort on {where_line(device)}"]


if __name__ == "__main__":
    for line in main(gate=True):
        print(line)
