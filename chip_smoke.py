#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc`` (the kernels are built from
``src/repro_torch/csrc`` at first use). Phases:

1. card and build: the card's name and power limit, the kernel build time;
2. each kernel against its plain PyTorch version on the card at the har
   width (D = 256 devices, T = 32 samples per tick, n = m = 561 features,
   Ñ = 128 hidden, ring hops = 2, hierarchical C = D/8), with kernel, plain
   and library-call times from CUDA events and the bound from the shapes;
   ``quantize_pack`` with and without a residual, bit for bit;
3. end to end: the port's ``FleetRuntime`` at the har width on star,
   hierarchical, hierarchical isolated, all_to_all and ring, with a shift
   injected into a few devices' streams so the participation mask is not
   all ones, and every routed kernel's launch count checked; then int8
   payloads (``payload_precision="int8"``) on star, hierarchical and ring,
   with tick and merge p50 beside the f32 runs, the governor's bytes per
   round and each round's f32 participants;
4. card against CPU: the same ticks at D = 16 through the port on the CPU
   (plain versions) and on the card, f32 and int8, losses within bounds
   and flags and merge decisions equal;
5. ``run_scenario`` on the ``driving``, ``har`` and ``mnist_like`` presets,
   on ring and star, f32 and int8, on the card and on the CPU: merges and
   detection stats equal, per-device AUCs within bounds;
6. ``torch.profiler`` over 7 ticks (2 merges) at the har width on star
   and ring: wall time, device time, the device's busy share and the
   kernels that took the most device time;
7. the kernel list, one JSON object per kernel, then the result line.

Any failed check raises and the script exits non-zero. Without a CUDA
device, or without the rest of the repository beside it, it exits
non-zero and prints no result line. Weights and data are random, made
from ``SEED``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
D, T, N_FEAT, N_HID = 256, 32, 561, 128   # har width (configs/oselm_edge.py)
RIDGE = 1e-3
HOPS = 2
TICKS = 16            # merges at ticks 3, 7, 11, 15 with merge_every = 4
SHIFT_TICK = 8        # from this tick on, the shifted devices see a new pattern
SHIFT_EVERY = 16      # every 16th device is shifted
RANK, NOISE = 24, 0.1
D_CPU = 16            # fleet size of the card-against-CPU phase

H100_F32_FLOPS = 67e12   # non-tensor-core f32, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12

# Tolerances, as max |kernel − plain| / max |plain|, taken for each output
# tensor on its own scale (P, β and the loss are orders of magnitude apart):
TOL = {
    # fixed-order sums in both, multiply and add rounded separately in both
    "masked_segment_sum_mix": 1e-6,
    # the same elimination with one fused multiply-add per update in both;
    # only the divisions' and the f64-emulated fma's last bits may differ
    "from_uv_solve": 1e-5,
    "banded_merge_solve": 1e-5,
    # the GEMM and dot products sum in other orders than cuBLAS, and the
    # 32-step RLS chain amplifies f32 rounding by up to κ(P)
    "fleet_ingest": 1e-4,
}
# card against CPU, per tick: the same reasons as tests/test_torch_runtime.py
LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-6
# int8 payloads after the first merge: a code that flips at a .5 boundary
# moves a payload value by a whole quantization step. Twice the spread of
# the reference's own XLA and kernel paths over 10 rounds
# (tests/test_torch_runtime.py, up to 2.5e-2)
INT8_LOSS_RTOL = 5e-2
# run_scenario, card against CPU, per device: f32 AUCs as the reference's
# (tests/test_torch_scenarios.py); int8 at twice the reference's own spread
# between its XLA and kernel paths on har (6.5e-3, same test)
AUC_TOL = {"f32": 1e-3, "int8": 1.3e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def make_streams(rng, d: int, n_init: int):
    """Data shaped like the har workload: every device draws windows from
    one low-rank activity pattern plus noise. ``x_init`` is each device's
    Eq. 13 boot chunk and ``ticks`` the (TICKS, d, T, n) stream. From
    SHIFT_TICK on, every SHIFT_EVERY-th device draws from a second pattern
    the fleet has not seen: the drift the detector has to flag."""
    import numpy as np

    bases = rng.standard_normal((2, RANK, N_FEAT)).astype(np.float32) / np.sqrt(RANK)

    def draw(pattern, rows):
        z = rng.standard_normal((len(pattern), rows, RANK)).astype(np.float32)
        x = np.einsum("drk,dkn->drn", z, bases[pattern])
        return (x + NOISE * rng.standard_normal(x.shape).astype(np.float32)).astype(np.float32)

    home = np.zeros(d, np.int64)
    x_init = draw(home, n_init)
    shifted = np.arange(d) % SHIFT_EVERY == 0
    ticks = []
    for t in range(TICKS):
        ticks.append(draw(np.where(shifted & (t >= SHIFT_TICK), 1, home), T))
    return x_init, np.stack(ticks), shifted


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want) -> tuple[float, list[float]]:
    """(max abs error over every output, [max |got − want| / max |want| of
    each output on its own])."""
    import torch

    assert all(bool(torch.isfinite(g).all()) for g in got), "non-finite kernel output"
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    return max(errs), [e / float(w.abs().max()) for e, w in zip(errs, want)]


def solve_flops(s: int, nh: int, m: int) -> float:
    """Least work of S solves P = (U + εI)⁻¹, β = P·V of SPD systems:
    an SPD inverse (Cholesky, triangular inverse, product) is Ñ³, and
    P·V is 2·Ñ²·m."""
    return s * (nh ** 3 + 2 * nh * nh * m)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels(fleet, window, topo_hier):
    """Each kernel against its plain version at the har width."""
    import torch

    from repro_torch.fleet import fleet_to_uv
    from repro_torch.kernels import fleet_ingest, topology_merge as tm
    from repro_torch.kernels.fleet_ingest import fleet_ingest_cuda, fleet_ingest_plain

    rows = {}
    d, t, n = window.shape
    nh, m = fleet.beta.shape[1], fleet.beta.shape[2]

    # ---- fused ingest
    got_s, got_l = fleet_ingest_cuda(fleet, window)
    ref_s, ref_l = fleet_ingest_plain(fleet, window)
    abs_e, rels = rel_err((got_s.p, got_s.beta, got_l), (ref_s.p, ref_s.beta, ref_l))
    flops = 2 * d * t * n * nh + 2 * d * t * nh * m + d * t * (6 * nh * nh + 4 * nh * m)
    nbytes = 4 * (d * t * n + n * nh + nh + 2 * d * nh * nh + 2 * d * nh * m + d)
    rows["fleet_ingest"] = dict(
        abs=abs_e, rels=dict(zip(("P", "beta", "loss"), rels)), flops=flops, nbytes=nbytes,
        ms=cuda_ms(lambda: fleet_ingest(fleet, window), 20),
        plain_ms=cuda_ms(lambda: fleet_ingest_plain(fleet, window), 3),
        library_ms=None,
    )

    # payloads of the ingested fleet, as the merge sees them
    trained = got_s
    uv = fleet_to_uv(trained, ridge=RIDGE)
    w = torch.cat([uv.u, uv.v], dim=2).contiguous()
    g = torch.Generator().manual_seed(SEED)
    mask = (torch.rand(d, generator=g) < 0.9).to(torch.float32).cuda()
    n_clusters = topo_hier.n_clusters
    cids = topo_hier.cluster_ids

    # ---- masked segment sum (hierarchical, C = D/8)
    sums = tm.masked_segment_sum_mix(w, cids, mask, n_clusters)
    ref = tm.masked_segment_sum_mix_plain(w, cids, mask, n_clusters)
    abs_e, rels = rel_err((sums,), (ref,))
    sel = torch.zeros(n_clusters, d, device="cuda")
    sel[torch.as_tensor(cids, device="cuda").long(), torch.arange(d, device="cuda")] = mask
    wf = w.view(d, -1)
    lib = torch.mm(sel, wf).view_as(ref)
    assert rel_err((lib,), (ref,))[1][0] < 1e-4, "library segment sum disagrees"
    e = nh * (nh + m)
    rows["masked_segment_sum_mix"] = dict(
        abs=abs_e, rels={"sums": rels[0]}, flops=2 * d * e, nbytes=4 * (d * e + n_clusters * e + 2 * d),
        ms=cuda_ms(lambda: tm.masked_segment_sum_mix(w, cids, mask, n_clusters), 50),
        plain_ms=cuda_ms(lambda: tm.masked_segment_sum_mix_plain(w, cids, mask, n_clusters), 3),
        library_ms=cuda_ms(lambda: torch.mm(sel, wf), 50),
    )

    # ---- Gauss-Jordan solves: one system (star, all_to_all) and the C
    # cluster sums of an isolated hierarchy, as the merge slices them
    # out of the packed [U | V]
    total = (w * mask[:, None, None]).sum(0, keepdim=True)
    eye = torch.eye(nh, device="cuda")
    solve_rows = {}
    for shape, packed in (("S=1", total), (f"S={n_clusters}", sums)):
        s = packed.shape[0]
        u1, v1 = packed[:, :, :nh], packed[:, :, nh:]
        got = tm.from_uv_solve(u1, v1, ridge=RIDGE)
        ref = tm.from_uv_solve_plain(u1, v1, ridge=RIDGE)
        abs_e, rels = rel_err(got, ref)
        a1 = u1 + RIDGE * eye
        rhs = torch.cat([eye.expand(s, nh, nh), v1], dim=2)
        lib = torch.linalg.solve(a1, rhs)
        lib_rels = rel_err((lib[:, :, :nh], lib[:, :, nh:]), ref)[1]
        log(f"  from_uv_solve {shape}: library solve against the plain version: "
            f"P max_rel={lib_rels[0]:.3e}, beta max_rel={lib_rels[1]:.3e}")
        solve_rows[shape] = dict(
            abs=abs_e, rels=dict(zip(("P", "beta"), rels)), flops=solve_flops(s, nh, m),
            nbytes=4 * s * (nh * nh + nh * m + nh * nh + nh * m),
            ms=cuda_ms(lambda: tm.from_uv_solve(u1, v1, ridge=RIDGE), 50),
            plain_ms=cuda_ms(lambda: tm.from_uv_solve_plain(u1, v1, ridge=RIDGE), 3),
            library_ms=cuda_ms(lambda: torch.linalg.solve(a1, rhs), 50),
        )
    # the kernel list carries the star shape; the cluster shape is logged
    # and its errors fold into the row's
    rows["from_uv_solve"] = one = solve_rows["S=1"]
    clusters = solve_rows[f"S={n_clusters}"]
    one["abs"] = max(one["abs"], clusters["abs"])
    one["rels"].update({f"{k} (S={n_clusters})": v for k, v in clusters["rels"].items()})
    clusters["bound_ms"], clusters["bound_by"] = bound(clusters["flops"], clusters["nbytes"])
    log(f"  from_uv_solve S={n_clusters}: ms={clusters['ms']:.4f} plain_ms={clusters['plain_ms']:.4f}"
        f" library_ms={clusters['library_ms']:.4f} bound_ms={clusters['bound_ms']:.4f}"
        f" ({clusters['bound_by']})")

    # ---- fused banded merge + solve (ring, hops = 2)
    wm = (w * mask[:, None, None]).contiguous()
    got = tm.banded_merge_solve(wm, HOPS, ridge=RIDGE)
    ref = tm.banded_merge_solve_plain(wm, HOPS, ridge=RIDGE)
    abs_e, rels = rel_err(got, ref)
    rows["banded_merge_solve"] = dict(
        abs=abs_e, rels=dict(zip(("P", "beta"), rels)),
        flops=d * 2 * HOPS * e + solve_flops(d, nh, m),
        nbytes=4 * (d * e + d * nh * nh + d * nh * m),
        ms=cuda_ms(lambda: tm.banded_merge_solve(wm, HOPS, ridge=RIDGE), 10),
        plain_ms=cuda_ms(lambda: tm.banded_merge_solve_plain(wm, HOPS, ridge=RIDGE), 2),
        library_ms=None,
    )

    rows["quantize_pack"] = phase_quantize_pack(uv)

    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r["flops"], r["nbytes"])
        if name == "quantize_pack":
            continue
        rels = " ".join(f"{k}={v:.3e}" for k, v in r["rels"].items())
        log(f"  {name:24s} max_abs={r['abs']:.3e} max_rel: {rels} (tol {TOL[name]:.0e})"
            f"  ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']}"
            f"  bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
    for name, r in rows.items():
        for out, rel in r["rels"].items():
            assert rel <= TOL[name], f"{name}: {out} disagrees with the plain version ({rel:.3e})"
    return rows


def mismatches(got, want) -> int:
    """Elements that differ, NaN matching NaN."""
    import torch

    differ = got != want
    if got.is_floating_point():
        differ &= ~(torch.isnan(got) & torch.isnan(want))
    return int(differ.sum())


def phase_quantize_pack(uv):
    """quantize_pack against its plain version at the har width, on the
    merge's payloads: without a residual (a first round) and with the
    residual that round leaves (every later round). Held bit for bit
    (codes, scales, residual): the arithmetic has no order to differ in."""
    from repro_torch.kernels import quantize_pack, quantize_pack_plain

    d, n, _ = uv.u.shape
    m = uv.v.shape[2]
    e = d * n * (n + m)
    first = quantize_pack(uv.u, uv.v)
    resid = first[2].contiguous()
    runs = {}
    for label, r in (("no residual", None), ("residual", resid)):
        got, want = quantize_pack(uv.u, uv.v, r), quantize_pack_plain(uv.u, uv.v, r)
        mism = {k: mismatches(g, w) for k, g, w in zip(("codes", "scales", "residual"), got, want)}
        nbytes = 4 * e * (1 if r is None else 2) + e + 4 * e + 4 * got[1].numel()
        runs[label] = dict(
            mism=mism, nbytes=nbytes,
            abs=max(float((got[1] - want[1]).abs().max()),
                    float((got[2] - want[2]).nan_to_num().abs().max())),
            ms=cuda_ms(lambda: quantize_pack(uv.u, uv.v, r), 50),
            plain_ms=cuda_ms(lambda: quantize_pack_plain(uv.u, uv.v, r), 3),
        )
        t_bytes = bound(5 * e, nbytes)
        log(f"  quantize_pack ({label}): mismatches {mism}  ms={runs[label]['ms']:.4f}"
            f" plain_ms={runs[label]['plain_ms']:.4f} library_ms=None"
            f"  bound_ms={t_bytes[0]:.4f} ({t_bytes[1]}, {nbytes / 1e6:.1f} MB)")
        for out, k in mism.items():
            assert k == 0, f"quantize_pack ({label}): {k} {out} differ from the plain version"
    # the kernel list carries the main path's shape: every round after the
    # first publishes against a residual
    row = runs["residual"]
    return dict(abs=max(r["abs"] for r in runs.values()), rels={}, flops=5 * e,
                nbytes=row["nbytes"], ms=row["ms"], plain_ms=row["plain_ms"], library_ms=None)


ROUTES = {
    "star": ("fleet_ingest", "masked_segment_sum_mix", "from_uv_solve"),
    "hierarchical": ("fleet_ingest", "masked_segment_sum_mix", "from_uv_solve"),
    "hierarchical_isolated": ("fleet_ingest", "masked_segment_sum_mix", "from_uv_solve"),
    "all_to_all": ("fleet_ingest", "from_uv_solve"),
    "ring": ("fleet_ingest", "banded_merge_solve"),
}


def topologies(d: int):
    from repro_torch.fleet import all_to_all, hierarchical, ring, star

    return {
        "star": star(d),
        "hierarchical": hierarchical(d, d // 8),
        "hierarchical_isolated": hierarchical(d, d // 8, head_exchange=False),
        "all_to_all": all_to_all(d),
        "ring": ring(d, HOPS),
    }


INT8_TOPOLOGIES = ("star", "hierarchical", "ring")


def runtime_config(topology, precision="f32"):
    from repro_torch.runtime import DetectorConfig, GovernorConfig, RuntimeConfig

    return RuntimeConfig(
        topology=topology, ridge=RIDGE,
        detector=DetectorConfig(warmup=5, warmup_skip=1, rel_sigma=0.05),
        governor=GovernorConfig(merge_every=4), payload_precision=precision,
    )


def drive(fleet, ticks_dev, name, precision):
    """One runtime over every tick, its launch counts set to 0 after the
    warmup and read at the end."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import FleetRuntime

    rt = FleetRuntime(fleet, runtime_config(topologies(D)[name], precision), device="cuda")
    rt.warmup(T)
    reset_launch_counts()
    tick_ms, reports = [], []
    for t in range(TICKS):
        t0 = time.perf_counter()
        reports.append(rt.tick(ticks_dev[t]))
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    assert bool(torch.isfinite(rt.states.p).all() and torch.isfinite(rt.states.beta).all())
    return rt, reports, tick_ms, counts


def phase_end_to_end(fleet, ticks_dev, shifted):
    """The port's FleetRuntime at the har width on every topology, f32 and
    then int8 payloads."""
    import numpy as np

    from repro_torch.fleet import payload_precision_nbytes

    totals, p50 = {}, {}
    for precision in ("f32", "int8"):
        names = topologies(D) if precision == "f32" else INT8_TOPOLOGIES
        for name in names:
            rt, reports, tick_ms, counts = drive(fleet, ticks_dev, name, precision)
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            rounds = [r for r in reports if r.decision.merge]
            merge_ms = [r.merge_seconds * 1e3 for r in rounds]
            masks = [r.decision.participants for r in rounds]
            flagged = rt.det.drifted.cpu().numpy()
            p50[precision, name] = (np.median(tick_ms), np.median(merge_ms))
            log(f"  {precision} {name:22s} tick_ms p50={np.median(tick_ms):.2f} max={max(tick_ms):.2f}"
                f"  merge_ms p50={np.median(merge_ms):.2f}"
                f"  merges={len(rounds)} participants={masks} detections={rt.detections_total}"
                f" flagged now: {int(flagged[shifted].sum())} shifted,"
                f" {int(flagged[~shifted].sum())} other  launches={counts}")
            assert len(rounds) >= 2, f"{name}: fewer than two admitted merges"
            assert min(masks) < D, f"{name}: every merge had every device; the mask went untested"
            for kernel in ROUTES[name]:
                assert counts[kernel] > 0, f"{name}: {kernel} was never launched"
            if precision == "int8":
                assert counts["quantize_pack"] == len(rounds), (
                    f"{name}: quantize_pack launched {counts['quantize_pack']} times in "
                    f"{len(rounds)} int8 rounds")
                fp = [r.decision.fp_participants for r in rounds]
                log(f"    bytes per round {[r.decision.round_bytes for r in rounds]}"
                    f" (all {D} at f32: {rt.governor.round_bytes(D, D)});"
                    f" f32 participants per round {fp}")
            else:
                assert counts["quantize_pack"] == 0
    f32_b = payload_precision_nbytes(N_HID, N_FEAT, "f32")
    q_b = payload_precision_nbytes(N_HID, N_FEAT, "int8")
    log(f"  bytes per payload: f32 {f32_b}, int8 {q_b} ({f32_b / q_b:.3f}x fewer)")
    for name in INT8_TOPOLOGIES:
        (tf, mf), (tq, mq) = p50["f32", name], p50["int8", name]
        log(f"  {name:12s} p50 f32 -> int8: tick {tf:.2f} -> {tq:.2f} ms,"
            f" merge {mf:.2f} -> {mq:.2f} ms")
    return totals


def phase_card_vs_cpu(fleet, ticks_np):
    """The same ticks at D_CPU devices on the CPU and on the card."""
    import numpy as np

    from repro_torch.runtime import FleetRuntime

    small = fleet.replace(beta=fleet.beta[:D_CPU].contiguous(), p=fleet.p[:D_CPU].contiguous())
    small_cpu = small.replace(
        params=type(small.params)(*(x.cpu() for x in small.params)),
        beta=small.beta.cpu(), p=small.p.cpu(),
    )
    for precision in ("f32", "int8"):
        for name in ("star", "ring"):
            topo = topologies(D_CPU)[name]
            card = FleetRuntime(small, runtime_config(topo, precision), device="cuda")
            cpu = FleetRuntime(small_cpu, runtime_config(topo, precision), device="cpu")
            worst, merges, flags, fp = 0.0, 0, 0, []
            for t in range(TICKS):
                batch = np.ascontiguousarray(ticks_np[t, :D_CPU])
                a, b = card.tick(batch), cpu.tick(batch)
                rtol = LOSS_RTOL if precision == "f32" or not merges else INT8_LOSS_RTOL
                np.testing.assert_allclose(a.losses, b.losses, rtol=rtol, atol=LOSS_ATOL)
                assert np.array_equal(a.drifted, b.drifted), f"{name} tick {t}: drifted differs"
                assert np.array_equal(a.fresh_detections, b.fresh_detections)
                da, db = a.decision, b.decision
                assert (da.merge, da.participants, da.round_bytes, da.fp_participants) == (
                    db.merge, db.participants, db.round_bytes, db.fp_participants)
                worst = max(worst, float(np.max(np.abs(a.losses - b.losses) / np.abs(b.losses))))
                merges += da.merge
                flags += int(a.fresh_detections.sum())
                if da.merge:
                    fp.append(da.fp_participants)
            assert merges >= 2
            log(f"  {precision} {name}: {TICKS} ticks at D={D_CPU}, losses max rel diff"
                f" {worst:.3e} (rtol {LOSS_RTOL:.0e}, int8 after a merge {INT8_LOSS_RTOL:.0e}),"
                f" flags {flags}, merges {merges}, f32 participants {fp}: equal")


def phase_scenarios():
    """run_scenario on the three presets, ring and star, f32 and int8, on
    the card (launch counts set to 0 just before, read just after) and on
    the CPU."""
    import numpy as np

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.scenarios import make_scenario, run_scenario

    totals = {}
    for preset in ("driving", "har", "mnist_like"):
        spec = make_scenario(preset)
        sc = spec.build()
        for topo in ("ring", "star"):
            for precision in ("f32", "int8"):
                reset_launch_counts()
                t0 = time.perf_counter()
                card = run_scenario(spec, topo, scenario=sc, payload_precision=precision,
                                    device="cuda")
                card_s = time.perf_counter() - t0
                counts = launch_counts()
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v
                cpu = run_scenario(spec, topo, scenario=sc, payload_precision=precision,
                                   device="cpu")
                local = float(np.abs(card.local_aucs - cpu.local_aucs).max())
                merged = float(np.abs(card.merged_aucs - cpu.merged_aucs).max())
                det = card.detection
                log(f"  {preset:10s} {topo:4s} {precision:4s} {card_s:5.2f} s:"
                    f" local AUC mean/min {card.local_aucs.mean():.4f}/{card.local_aucs.min():.4f},"
                    f" merged {card.merged_aucs.mean():.4f}/{card.merged_aucs.min():.4f};"
                    f" merges {card.merges}, comm bytes {card.comm_bytes};"
                    f" detections: delays {det['delays']} missed {det['missed']}"
                    f" false positives {det['false_positives']};"
                    f" card - CPU AUC max |diff| local {local:.2e} merged {merged:.2e}")
                rounds = [(r.decision.participants, r.decision.fp_participants)
                          for r in card.reports if r.decision.merge]
                log(f"    rounds (participants, of them at f32): {rounds}")
                assert (card.merges, card.comm_bytes) == (cpu.merges, cpu.comm_bytes)
                assert card.detection == cpu.detection, f"{preset} {topo} {precision}: detections"
                assert max(local, merged) <= AUC_TOL[precision], (
                    f"{preset} {topo} {precision}: AUCs differ by {max(local, merged):.2e}")
                routed = ("fleet_ingest",) + (("quantize_pack",) if precision == "int8" else ())
                for kernel in routed:
                    assert counts[kernel] > 0, f"{preset} {topo}: {kernel} was never launched"
    log(f"  launches {totals}")


def phase_profile(fleet, ticks_dev):
    """Where a tick's time goes: ticks 1–7 (merges at 3 and 7) under
    torch.profiler, after a first tick outside the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import FleetRuntime

    for name in ("star", "ring"):
        rt = FleetRuntime(fleet, runtime_config(topologies(D)[name]), device="cuda")
        rt.warmup(T)
        rt.tick(ticks_dev[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(1, 8):
                rt.tick(ticks_dev[t])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3
        assert dev_ms > 0, "the profiler saw no device time"
        log(f"  {name}: 7 ticks, wall {wall_ms:.2f} ms, device {dev_ms:.2f} ms,"
            f" busy share {dev_ms / wall_ms:.3f}")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.fleet import hierarchical, init_fleet
    from repro_torch.kernels import _lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    start = time.perf_counter()
    log("phase 1: card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"  nvidia-smi: {smi}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")
    t0 = time.perf_counter()
    lib_path = _lib.build()
    _lib.library()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s: {lib_path.relative_to(ROOT)}")

    rng = np.random.default_rng(SEED)
    x_init, ticks_np, shifted = make_streams(rng, D, 2 * N_HID)
    fleet = init_fleet(torch.Generator().manual_seed(SEED), D, N_FEAT, N_HID, x_init,
                       activation="identity", ridge=RIDGE, device="cuda")
    del x_init
    ticks_dev = torch.from_numpy(ticks_np).cuda()

    log("phase 2: each kernel against its plain version at the har width")
    rows = phase_kernels(fleet, ticks_dev[0], hierarchical(D, D // 8))

    log("phase 3: end to end, FleetRuntime at the har width")
    launches = phase_end_to_end(fleet, ticks_dev, shifted)

    log("phase 4: card against CPU")
    phase_card_vs_cpu(fleet, ticks_np)

    log("phase 5: run_scenario on the paper's three workloads, card against CPU")
    phase_scenarios()

    log("phase 6: where a tick's time goes (torch.profiler)")
    phase_profile(fleet, ticks_dev)

    log(f"phase 7: kernels (phases 1-6 took {time.perf_counter() - start:.1f} s)")
    sources = {
        "fleet_ingest": ("src/repro_torch/csrc/fleet_ingest.cu",
                         "src/repro/kernels/fleet_ingest.py:284"),
        "masked_segment_sum_mix": ("src/repro_torch/csrc/topology_merge.cu",
                                   "src/repro/kernels/topology_merge.py:242"),
        "from_uv_solve": ("src/repro_torch/csrc/topology_merge.cu",
                          "src/repro/kernels/topology_merge.py:411"),
        "banded_merge_solve": ("src/repro_torch/csrc/topology_merge.cu",
                               "src/repro/kernels/topology_merge.py:491"),
        "quantize_pack": ("src/repro_torch/csrc/quantize_pack.cu",
                          "src/repro/kernels/quantize_pack.py:106"),
    }
    log("  " + ", ".join(f"{k}: {v} launches" for k, v in launches.items()))
    kernels = []
    for name, r in rows.items():
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["abs"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
