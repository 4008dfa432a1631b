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
3. end to end: the port's ``FleetRuntime`` at the har width on star,
   hierarchical, hierarchical isolated, all_to_all and ring, with a shift
   injected into a few devices' streams so the participation mask is not
   all ones, and every routed kernel's launch count checked;
4. card against CPU: the same ticks at D = 16 through the port on the CPU
   (plain versions) and on the card, losses within bounds and flags and
   merge decisions equal;
5. ``torch.profiler`` over 7 ticks (2 merges) at the har width on star
   and ring: wall time, device time, the device's busy share and the
   kernels that took the most device time;
6. the kernel list, one JSON object per kernel, then the result line.

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

    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r["flops"], r["nbytes"])
        rels = " ".join(f"{k}={v:.3e}" for k, v in r["rels"].items())
        log(f"  {name:24s} max_abs={r['abs']:.3e} max_rel: {rels} (tol {TOL[name]:.0e})"
            f"  ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']}"
            f"  bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
    for name, r in rows.items():
        for out, rel in r["rels"].items():
            assert rel <= TOL[name], f"{name}: {out} disagrees with the plain version ({rel:.3e})"
    return rows


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


def runtime_config(topology):
    from repro_torch.runtime import DetectorConfig, GovernorConfig, RuntimeConfig

    return RuntimeConfig(
        topology=topology, ridge=RIDGE,
        detector=DetectorConfig(warmup=5, warmup_skip=1, rel_sigma=0.05),
        governor=GovernorConfig(merge_every=4),
    )


def phase_end_to_end(fleet, ticks_dev, shifted):
    """The port's FleetRuntime at the har width on every topology."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import FleetRuntime

    totals = dict.fromkeys(launch_counts(), 0)
    for name, topo in topologies(D).items():
        rt = FleetRuntime(fleet, runtime_config(topo), device="cuda")
        rt.warmup(T)
        reset_launch_counts()
        tick_ms, merge_ms, masks = [], [], []
        for t in range(TICKS):
            t0 = time.perf_counter()
            rep = rt.tick(ticks_dev[t])
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            if rep.decision.merge:
                merge_ms.append(rep.merge_seconds * 1e3)
                masks.append(rep.decision.participants)
        counts = launch_counts()
        for k, v in counts.items():
            totals[k] += v
        assert bool(torch.isfinite(rt.states.p).all() and torch.isfinite(rt.states.beta).all())
        flagged = rt.det.drifted.cpu().numpy()
        merges = len(merge_ms)
        log(f"  {name:22s} tick_ms p50={np.median(tick_ms):.2f} max={max(tick_ms):.2f}"
            f"  merge_ms p50={np.median(merge_ms):.2f}"
            f"  merges={merges} participants={masks} detections={rt.detections_total}"
            f" flagged now: {int(flagged[shifted].sum())} shifted, {int(flagged[~shifted].sum())} other"
            f"  launches={counts}")
        assert merges >= 2, f"{name}: fewer than two admitted merges"
        assert min(masks) < D, f"{name}: every merge had every device; the mask went untested"
        for kernel in ROUTES[name]:
            assert counts[kernel] > 0, f"{name}: {kernel} was never launched"
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
    for name in ("star", "ring"):
        topo = topologies(D_CPU)[name]
        card = FleetRuntime(small, runtime_config(topo), device="cuda")
        cpu = FleetRuntime(small_cpu, runtime_config(topo), device="cpu")
        worst, merges, flags = 0.0, 0, 0
        for t in range(TICKS):
            batch = np.ascontiguousarray(ticks_np[t, :D_CPU])
            a, b = card.tick(batch), cpu.tick(batch)
            np.testing.assert_allclose(a.losses, b.losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
            assert np.array_equal(a.drifted, b.drifted), f"{name} tick {t}: drifted differs"
            assert np.array_equal(a.fresh_detections, b.fresh_detections)
            assert (a.decision.merge, a.decision.participants, a.decision.round_bytes) == (
                b.decision.merge, b.decision.participants, b.decision.round_bytes)
            worst = max(worst, float(np.max(np.abs(a.losses - b.losses) / np.abs(b.losses))))
            merges += a.decision.merge
            flags += int(a.fresh_detections.sum())
        assert merges >= 2
        log(f"  {name}: {TICKS} ticks at D={D_CPU}, losses max rel diff {worst:.3e} "
            f"(rtol {LOSS_RTOL:.0e}), flags {flags}, merges {merges}: equal")


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

    log("phase 5: where a tick's time goes (torch.profiler)")
    phase_profile(fleet, ticks_dev)

    log("phase 6: kernels")
    sources = {
        "fleet_ingest": ("src/repro_torch/csrc/fleet_ingest.cu",
                         "src/repro/kernels/fleet_ingest.py:284"),
        "masked_segment_sum_mix": ("src/repro_torch/csrc/topology_merge.cu",
                                   "src/repro/kernels/topology_merge.py:242"),
        "from_uv_solve": ("src/repro_torch/csrc/topology_merge.cu",
                          "src/repro/kernels/topology_merge.py:411"),
        "banded_merge_solve": ("src/repro_torch/csrc/topology_merge.cu",
                               "src/repro/kernels/topology_merge.py:491"),
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
