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
   ``quantize_pack`` with and without a residual (each also alone, by
   ``torch.profiler``), ``robust_segment_sum_mix``
   (star and hierarchical, trim 1 and 2, devices masked, clip scales below
   1) and ``dense_mix`` (a seeded symmetric 0/1 mask, and the edges of its
   tile), bit for bit; ``from_uv_solve`` at S = 1, 32 and 256 (the stale
   round's per-device solves) and ``torch.linalg.solve`` each alone
   (``torch.profiler``), with the count of elements that differ from the
   plain version and a second call bit-identical; ``banded_merge_solve``
   (ring, hops = 2) with no element differing from its plain version and
   its kernel alone; ``masked_segment_sum_mix`` and its library product
   alone; ``fleet_ingest`` alone, the sum of its four kernels;
3. end to end: the port's ``FleetRuntime`` at the har width on star,
   hierarchical, hierarchical isolated, all_to_all and ring, with a shift
   injected into a few devices' streams so the participation mask is not
   all ones, and every routed kernel's launch count checked; then int8
   payloads (``payload_precision="int8"``) on star, hierarchical and ring,
   with tick and merge p50 beside the f32 runs, the governor's bytes per
   round and each round's f32 participants; then the hardened runtime
   (the ``adversarial`` preset's ×−25 scale attack on 10 % of the devices,
   a NaN device and a crash window) with the robust merge (trim 1; trim 0
   on a custom dense mask) on star, hierarchical, all_to_all, ring and a
   custom dense mask, and the naive merge on star: tick and merge p50,
   non-finite payloads and robust-quarantined devices per round, each
   honest device's distance from a clean run's β, and launches of the two
   robust-path kernels equal to the rounds routed to them;
4. card against CPU: the same ticks at D = 16 through the port on the CPU
   (plain versions) and on the card, f32, int8 and hardened, losses within
   bounds and flags, merge decisions, non-finite counts and robust
   quarantines equal;
5. ``run_scenario`` on the ``driving``, ``har`` and ``mnist_like`` presets,
   on ring and star, f32 and int8, and on ``adversarial`` (robust merge),
   on the card and on the CPU: merges and detection stats (and on
   ``adversarial`` the robust quarantines) equal, per-device AUCs within
   bounds;
6. ``torch.profiler`` over 7 ticks (2 merges) at the har width on star
   and ring: wall time, device time, the device's busy share and the
   kernels that took the most device time;
7. the paper's single-device path at the har width: ``hidden_proj`` and
   ``matmul_atb`` (two calls bit-identical; ``hidden_proj`` also at the
   edges of its split and k=1 kernels, f32 and bf16, and each activation
   applied once to the finished sum), ``rank1_add`` and the k=1 step's
   tail in one launch (``k1_update``, also at odd widths) against
   their plain versions, with the device time of each call's kernels, a
   256-step k=1 chain card against CPU (one ``k1_update`` a step), two
   devices and their cooperative update, the pair evaluations, Fig. 18 and
   Table 4, a profiler pass over 200 k=1 steps with the launches a step;
8. repeated synchronisation and stale merges at the har width (D = 256):
   (a) ``segment_sum_mix`` (star and C = 32), ``segment_broadcast``
   (32 → 256) and ``banded_mix`` (hops 2) against their plain versions bit
   for bit, with CUDA-event, profiler, plain and library times and the
   bound; (b) ``fleet_train_rounds``, 4 rounds of 32 samples on star,
   hierarchical (both head modes), all_to_all and ring; (c)
   ``fleet_train_async`` with a random schedule of lags up to 3 on the
   same topologies, lag 0 equal to (b), and a profile of 4 rounds of each
   on star and ring; (d) ``FleetRuntime`` with that
   schedule on ring and isolated hierarchical; every kernel's launches
   equal to the rounds routed to it; (e) (b), (c) and (d) card against CPU
   at D = 16;
9. serving ``hymba-1.5b`` at full width (32 layers, d_model 1600, bf16):
   (a) ``flash_attention`` (B = 4, S = 512, 1024 and 2048, H = 25,
   hd = 64, causal; S = 1000 full; hd = 256) and ``gla_forward`` (S = 512,
   1000 and 2048, dk = 16, dv = 64) against their plain versions, bf16 and
   f32, row by row, with CUDA-event, profiler, plain and
   ``scaled_dot_product_attention`` times and the bound; (b)
   ``repro_torch.launch.serve.serve`` on random weights from ``SEED``: 3
   rounds of 4 prompts of 512 tokens and 16 greedy tokens, the drift at
   round 2 (its score above the other rounds'), then one round at 2048
   tokens (local attention in the 29 sliding-window layers), each
   prefill's launches of the two kernels checked; (c) full width in f32 at
   2 layers, card against CPU: prefill logits, features and caches and 8
   decode steps; (d) a profile of one prefill and 16 decode steps;
10. wide layers and the other sizes past the cluster paths: (a) the
    port's ``FleetRuntime`` at D = 16, Ñ = 256 and at D = 8, Ñ = 384 (past
    the cluster solve and P chain), the har width otherwise, on f32 star,
    f32 ring, int8 star and the stale ring (lags up to 3), six ticks, the
    shifted device flagged at the last, merges every 3 ticks (the second
    without it), card against CPU (flags and decisions equal, losses within
    phase 4's bounds) and each route's kernels launched; (b) at Ñ = 320
    (m = 561), 768 and 1024 (m = 784, the mnist_like width),
    ``from_uv_solve`` (S = 1 and 16) and ``banded_merge_solve`` (hops 2)
    with no element differing from their plain versions, ``quantize_pack``
    bit for bit, ``fleet_ingest`` (T = 32 and 64 at 320, 32 at 768) within
    1e-4, each with its time alone and by events and its bound; (c)
    ``banded_mix`` at hops 227 on 455 devices and (d)
    ``robust_segment_sum_mix`` at trim 5 and 8 on the har-width star, bit
    for bit; (e) ``flash_attention`` at B·H = 65 600 against its plain
    version; (f) ``gla_forward`` past one block's shared memory, at
    dk × dv = 128 × 128 and xLSTM's 512 × 513 (B = 1, S = 2048, H = 4),
    bf16 and f32, on its tiled wide path; (g) ``flash_attention`` at head
    widths 80, 96 and 320 (B = 4, S = 512, H = 25) and on a bf16 view off
    a 16-byte boundary; each against its plain version, with its time
    alone, its bound and ``scaled_dot_product_attention``'s time;
11. telemetry and the paper's §5 table: (a) ``FleetRuntime`` on the
    har-width star (D = 256) without and with ``TelemetryConfig()``, in
    turns (off, on, on, off, twice): reports equal tick for tick, bit for bit;
    the sink's bytes, merge rounds and detections equal to the governor's
    ledger and the reports; tick p50/p99 from the sink and the overhead;
    (b) ``benchmarks/torch_paper_eval.py``'s smoke grid (driving, har,
    mnist_like on ring and star) in f32 and int8: its claims asserted,
    every routed kernel launched, one row per (scenario, topology);
12. durability at the har width: (a) the hardened star with telemetry
    (phase 3's faults) snapshotting every 16 ticks, killed at tick 40, its
    newest snapshot cut to 128 bytes, a new runtime restored from the one
    before and replayed to tick 64: the tail bit for bit equal to an
    uninterrupted card run's, telemetry continuous, each kernel launched as
    often as in the uninterrupted tail; the snapshot's bytes, save and
    restore seconds, and the host time of snapshot ticks beside the same
    ticks without one; (b) a D = 16 card snapshot (f32 and hardened star)
    restored on the CPU and ticked against the card at phase 4's bounds;
13. the paper's device-level API at the har width, on the card and the
    same run on the CPU: four ``EdgeDevice``s booted and trained under a
    registered activation (one poisoned), ``cooperative_round`` with
    ``loss_threshold_selection`` (the same devices chosen, the comm log
    equal, Ñ(Ñ+m)·4 bytes an upload, AUCs within bounds), 64 k=1 steps of a
    merged device and ``train_elm``, with each routed kernel's launches
    (``hidden_proj``, ``matmul_atb``, ``rank1_add``, ``fleet_ingest``);
14. the kernel list, one JSON object per kernel, then the result line.

Any failed check raises and the script exits non-zero. Without a CUDA
device, or without the rest of the repository beside it, it exits
non-zero and prints no result line. Weights and data are random, made
from ``SEED``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

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
H100_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores, same sheet
H100_BYTES_PER_S = 3.35e12

# Tolerances, as max |kernel − plain| / max |plain|, taken for each output
# tensor on its own scale (P, β and the loss are orders of magnitude apart):
TOL = {
    # fixed-order sums in both, multiply and add rounded separately in both
    "masked_segment_sum_mix": 1e-6,
    # the same elimination, IEEE divisions and one fused multiply-add per
    # update rounded once in both: equal bits (the differing elements are
    # counted and logged); the bound is the one the solves have always had
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
# hardened runtime, card against CPU, after the first merge: the robust arm
# solves by Cholesky and eigh (cuSOLVER on the card, LAPACK on the CPU), and
# the trimmed mean and κ(U) carry their last-bit differences into the
# losses; tests/test_torch_runtime.py measured 2.3e-4 between the port and
# the reference on the same kind of fixture and holds it at 5e-4
HARD_LOSS_RTOL = 5e-4
SCORE_RTOL, SCORE_ATOL = 1e-3, 1e-3   # outlier scores, as that test holds them


def log(msg: str) -> None:
    print(msg, flush=True)


def make_streams(rng, d: int, n_init: int, n_feat: int = N_FEAT):
    """Data shaped like the har workload (n_feat features): every device
    draws windows from one low-rank activity pattern plus noise. ``x_init``
    is each device's Eq. 13 boot chunk and ``ticks`` the (TICKS, d, T, n)
    stream. From SHIFT_TICK on, every SHIFT_EVERY-th device draws from a
    second pattern the fleet has not seen: the drift the detector has to
    flag."""
    import numpy as np

    bases = rng.standard_normal((2, RANK, n_feat)).astype(np.float32) / np.sqrt(RANK)

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


def device_ms(fn, reps: int, kernels: tuple[str, ...] | dict[str, int]) -> float | None:
    """Device time of one wrapper call, from torch.profiler over ``reps``
    calls: the kernels alone, without the wrapper's host work, which bounds
    a short kernel's CUDA-event time. A call launches each kernel whose name
    holds one of ``kernels`` once (``matmul_atb``'s split product launches
    two), or as often as a dict of ``kernels`` says (the wide solve's panel
    kernels, once a panel), so the time is the sum over ``kernels`` of the
    mean time of a launch times its launches a call. Means, not totals over
    ``reps``: a session now and then drops
    some of the launches (seen on an H100: 3 of 4, 4 of 10) or all of them
    (a 2 µs kernel, in three sessions running), and is then asked again.
    None, printed as not measured, when five sessions missed a kernel: the
    time is a log line's, and no check reads it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    per_call = kernels if isinstance(kernels, dict) else dict.fromkeys(kernels, 1)
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        means = []
        for kernel, times in per_call.items():
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
            launches = sum(e.count for e in events)
            if launches > 0:
                means.append(times * sum(e.self_device_time_total for e in events) / 1e3
                             / launches)
        if len(means) == len(kernels):
            return sum(means)
    return None


def ms_text(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def call_device(fn, reps: int, what: str = "library alone") -> str:
    """Device time of one call of ``fn`` (every kernel it launches) and the
    name of its longest kernel, from torch.profiler over ``reps`` calls.
    Each kernel's mean launch time counts once for each launch a call
    makes, so a dropped launch does not shorten it."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0]
    if not events:
        return f"{what} not measured"
    ms = sum(e.self_device_time_total / e.count * math.ceil(e.count / reps) for e in events)
    top = max(events, key=lambda e: e.self_device_time_total)
    return f"{what} {ms / 1e3:.4f}: {top.key[:72]}"


def library_device(fn, reps: int) -> str:
    """One PyTorch library call's device time: the yardstick beside a
    kernel's own time alone."""
    return call_device(fn, reps)


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


def bound(flops: float, nbytes: float, flops_per_s: float = H100_F32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / flops_per_s * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# the kernels one fleet_ingest call launches, as the profiler names them,
# and past Ñ = 320
INGEST_KERNELS = ("gemm_tile_kernel", "ingest_gain_kernel", "ingest_beta_kernel",
                  "ingest_loss_kernel")
WIDE_INGEST_KERNELS = ("gemm_tile_kernel", "ingest_gain_wide_kernel", "ingest_beta_wide_kernel",
                       "ingest_loss_kernel")


def solve_kernels(n: int) -> dict[str, int]:
    """The kernels one from_uv_solve or banded_merge_solve call launches at
    Ñ = n, with their launches a call: the cluster solve once up to
    Ñ = 320, else the load and two launches a panel of 32 pivots."""
    if n <= 320:
        return {"uv_solve_cluster_kernel": 1}
    panels = -(-n // 32)
    return {"uv_wide_load_kernel": 1, "uv_wide_panel_kernel": panels,
            "uv_wide_update_kernel": panels}


def ingest_work(d: int, t: int, n: int, nh: int, m: int) -> tuple[float, float]:
    """(flops, bytes) of one fleet_ingest call in the kernel's order: the
    projection, E₀ and the ordered β update (2·Ñ·m a sample each), the P
    chain (6·Ñ² a sample), and, for each pair s < t of a chunk, L[t, s]
    (2·Ñ) and its substitution (2·m); inputs read and outputs written once."""
    from repro_torch.kernels.fleet_ingest import ingest_chunk, ingest_chunks

    pairs = sum((c1 - c0) * (c1 - c0 - 1) // 2 for c0, c1 in ingest_chunks(t, ingest_chunk(nh)))
    flops = (2 * d * t * n * nh + 4 * d * t * nh * m + 6 * d * t * nh * nh
             + 2 * d * pairs * (nh + m))
    nbytes = 4 * (d * t * n + n * nh + nh + 2 * d * nh * nh + 2 * d * nh * m + d)
    return flops, nbytes


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
    flops, nbytes = ingest_work(d, t, n, nh, m)
    rows["fleet_ingest"] = dict(
        abs=abs_e, rels=dict(zip(("P", "beta", "loss"), rels)), flops=flops, nbytes=nbytes,
        ms=cuda_ms(lambda: fleet_ingest(fleet, window), 20),
        plain_ms=cuda_ms(lambda: fleet_ingest_plain(fleet, window), 3),
        library_ms=None,
    )
    again_s, again_l = fleet_ingest_cuda(fleet, window)
    assert torch.equal(again_s.beta, got_s.beta) and torch.equal(again_l, got_l), (
        "fleet_ingest: a second call gave other bits")
    # the kernels alone: the projection, the P chain, the β tiles, the loss
    alone = {k: device_ms(lambda: fleet_ingest(fleet, window), 20, (k,)) for k in INGEST_KERNELS}
    total = None if None in alone.values() else sum(alone.values())
    log(f"  fleet_ingest: ms={rows['fleet_ingest']['ms']:.4f} (kernels alone {ms_text(total)}: "
        + ", ".join(f"{k} {ms_text(v)}" for k, v in alone.items()) + ")")

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
    alone = device_ms(lambda: tm.masked_segment_sum_mix(w, cids, mask, n_clusters), 20,
                      ("segsum_kernel<true>",))
    log(f"  masked_segment_sum_mix C={n_clusters}: kernel alone {ms_text(alone)},"
        f" {library_device(lambda: torch.mm(sel, wf), 20)}")

    # ---- Gauss-Jordan solves: one system (star, all_to_all), the C
    # cluster sums of an isolated hierarchy and the D per-device solves of a
    # stale round, each as the merge slices it out of a packed [U | V]
    total = (w * mask[:, None, None]).sum(0, keepdim=True)
    eye = torch.eye(nh, device="cuda")
    solve_rows = {}
    for shape, packed in (("S=1", total), (f"S={n_clusters}", sums), (f"S={d}", w)):
        s = packed.shape[0]
        u1, v1 = packed[:, :, :nh], packed[:, :, nh:]
        got = tm.from_uv_solve(u1, v1, ridge=RIDGE)
        ref = tm.from_uv_solve_plain(u1, v1, ridge=RIDGE)
        abs_e, rels = rel_err(got, ref)
        again = tm.from_uv_solve(u1, v1, ridge=RIDGE)
        assert all(torch.equal(a, g) for a, g in zip(again, got)), (
            f"from_uv_solve {shape}: a second call gave other bits")
        differ = sum(mismatches(g, r) for g, r in zip(got, ref))
        a1 = u1 + RIDGE * eye
        rhs = torch.cat([eye.expand(s, nh, nh), v1], dim=2)
        lib = torch.linalg.solve(a1, rhs)
        lib_rels = rel_err((lib[:, :, :nh], lib[:, :, nh:]), ref)[1]
        log(f"  from_uv_solve {shape}: {differ} of {s * nh * (nh + m)} elements differ from the"
            f" plain version; library solve against the plain version: "
            f"P max_rel={lib_rels[0]:.3e}, beta max_rel={lib_rels[1]:.3e}")
        solve_rows[shape] = r = dict(
            abs=abs_e, rels=dict(zip(("P", "beta"), rels)), flops=solve_flops(s, nh, m),
            nbytes=4 * s * (nh * nh + nh * m + nh * nh + nh * m),
            ms=cuda_ms(lambda: tm.from_uv_solve(u1, v1, ridge=RIDGE), 50 if s < d else 10),
            plain_ms=cuda_ms(lambda: tm.from_uv_solve_plain(u1, v1, ridge=RIDGE), 3),
            library_ms=cuda_ms(lambda: torch.linalg.solve(a1, rhs), 50 if s < d else 10),
        )
        r["bound_ms"], r["bound_by"] = bound(r["flops"], r["nbytes"])
        # the kernel alone and the library call alone, for ranking the two
        alone = device_ms(lambda: tm.from_uv_solve(u1, v1, ridge=RIDGE), 20,
                          ("uv_solve_cluster_kernel",))
        log(f"  from_uv_solve {shape}: ms={r['ms']:.4f} (kernel alone {ms_text(alone)})"
            f" plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f}"
            f" (torch.linalg.solve, {library_device(lambda: torch.linalg.solve(a1, rhs), 20)})"
            f" bound_ms={r['bound_ms']:.6f} ({r['bound_by']})")
    # the kernel list carries the star shape; the other shapes are logged
    # and their errors fold into the row's
    rows["from_uv_solve"] = one = solve_rows.pop("S=1")
    for shape, other in solve_rows.items():
        one["abs"] = max(one["abs"], other["abs"])
        one["rels"].update({f"{k} ({shape})": v for k, v in other["rels"].items()})

    # ---- fused banded merge + solve (ring, hops = 2): from_uv_solve's
    # kernel, its loader summing each device's band in the plain version's
    # order, so no element may differ. The work: the 2·hops adds of each
    # element of a band and the solve's least work (as csrc/topology_merge.cu
    # counts it); the bytes: the payloads read once, P and β written once
    wm = (w * mask[:, None, None]).contiguous()
    got = tm.banded_merge_solve(wm, HOPS, ridge=RIDGE)
    ref = tm.banded_merge_solve_plain(wm, HOPS, ridge=RIDGE)
    abs_e, rels = rel_err(got, ref)
    differ = sum(mismatches(g, r) for g, r in zip(got, ref))
    again = tm.banded_merge_solve(wm, HOPS, ridge=RIDGE)
    assert all(torch.equal(a, g) for a, g in zip(again, got)), (
        "banded_merge_solve: a second call gave other bits")
    rows["banded_merge_solve"] = r = dict(
        abs=abs_e, rels=dict(zip(("P", "beta"), rels)),
        flops=d * 2 * HOPS * e + solve_flops(d, nh, m),
        nbytes=4 * (d * e + d * nh * nh + d * nh * m),
        ms=cuda_ms(lambda: tm.banded_merge_solve(wm, HOPS, ridge=RIDGE), 10),
        plain_ms=cuda_ms(lambda: tm.banded_merge_solve_plain(wm, HOPS, ridge=RIDGE), 2),
        library_ms=None,
    )
    alone = device_ms(lambda: tm.banded_merge_solve(wm, HOPS, ridge=RIDGE), 10,
                      ("uv_solve_cluster_kernel",))
    log(f"  banded_merge_solve D={d} hops={HOPS}: {differ} of {d * e} elements differ from the"
        f" plain version; ms={r['ms']:.4f} (kernel alone {ms_text(alone)})")
    assert differ == 0, f"banded_merge_solve: {differ} elements differ from the plain version"

    rows["quantize_pack"] = phase_quantize_pack(uv)
    rows["robust_segment_sum_mix"] = phase_robust_segment_sum(w, mask, topo_hier)
    rows["dense_mix"] = phase_dense_mix(w)

    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r["flops"], r["nbytes"])
        if not r["rels"]:  # held bit for bit and logged by its own phase
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
            device_ms=device_ms(lambda: quantize_pack(uv.u, uv.v, r), 20,
                                ("quantize_pack_kernel",)),
        )
        t_bytes = bound(5 * e, nbytes)
        log(f"  quantize_pack ({label}): mismatches {mism}  ms={runs[label]['ms']:.4f}"
            f" (kernel alone {ms_text(runs[label]['device_ms'])})"
            f" plain_ms={runs[label]['plain_ms']:.4f} library_ms=None"
            f"  bound_ms={t_bytes[0]:.4f} ({t_bytes[1]}, {nbytes / 1e6:.1f} MB)")
        for out, k in mism.items():
            assert k == 0, f"quantize_pack ({label}): {k} {out} differ from the plain version"
    # the kernel list carries the main path's shape: every round after the
    # first publishes against a residual
    row = runs["residual"]
    return dict(abs=max(r["abs"] for r in runs.values()), rels={}, flops=5 * e,
                nbytes=row["nbytes"], ms=row["ms"], plain_ms=row["plain_ms"], library_ms=None)


def phase_robust_segment_sum(w, mask, topo_hier):
    """robust_segment_sum_mix against its plain version at the har width on
    the merge's payloads: one cluster (star) and the hierarchy's C = D/8,
    trim 1 and 2, with the phase's masked devices and clip scales below 1
    (clip norm at the median payload norm, so about half the devices are
    clipped). Held bit for bit (tot, lo, hi): the plain version repeats
    the kernel's operations in its order."""
    import numpy as np

    from repro_torch.fleet import payload_clip
    from repro_torch.kernels import robust_segment_sum_mix, robust_segment_sum_mix_plain

    d, n, c = w.shape
    e = n * c
    _, scale = payload_clip(w, float(w.flatten(1).norm(dim=1).median()))
    log(f"  robust_segment_sum_mix: {int((scale < 1).sum())} of {d} devices clipped,"
        f" {int((mask == 0).sum())} masked")
    runs = {}
    for topo, trim in (("star", 1), ("star", 2), ("hierarchical", 1), ("hierarchical", 2)):
        if topo == "star":
            cids, n_cl = np.zeros(d, np.int32), 1
        else:
            cids, n_cl = topo_hier.cluster_ids, topo_hier.n_clusters
        args = (w, cids, mask, scale, n_cl, trim)
        got, want = robust_segment_sum_mix(*args), robust_segment_sum_mix_plain(*args)
        mism = {k: mismatches(g, x) for k, g, x in zip(("tot", "lo", "hi"), got, want)}
        # reads x, mask, scale and the cluster offsets once, writes tot, lo
        # and hi; per element read a scale multiply, a mask multiply-add
        # and 2·trim min/max pairs
        nbytes = 4 * (d * e + 2 * d + n_cl + 1 + 3 * n_cl * e)
        flops = (4 + 4 * trim) * d * e
        r = runs[topo, trim] = dict(
            abs=max(float((g - x).abs().max()) for g, x in zip(got, want)), rels={},
            flops=flops, nbytes=nbytes, library_ms=None,
            ms=cuda_ms(lambda: robust_segment_sum_mix(*args), 50),
            plain_ms=cuda_ms(lambda: robust_segment_sum_mix_plain(*args), 2),
        )
        kernel_ms = device_ms(lambda: robust_segment_sum_mix(*args), 20,
                              ("robust_segsum_kernel",))
        b = bound(flops, nbytes)
        log(f"  robust_segment_sum_mix ({topo}, C={n_cl}, trim={trim}): mismatches {mism}"
            f"  ms={r['ms']:.4f} (kernel alone {ms_text(kernel_ms)})"
            f" plain_ms={r['plain_ms']:.4f} library_ms=None"
            f"  bound_ms={b[0]:.4f} ({b[1]}, {nbytes / 1e6:.1f} MB)")
        for out, k in mism.items():
            assert k == 0, f"robust_segment_sum_mix ({topo}, trim={trim}): {k} {out} differ"
    # the kernel list carries the adversarial preset's shape: star, trim 1
    return runs["star", 1]


def dense_mask(d: int):
    """A seeded symmetric 0/1 mask with its diagonal set: each device
    merges with itself and about 5 % of the fleet, no ring and no cluster."""
    import numpy as np

    m = (np.random.default_rng(SEED + 1).random((d, d)) < 0.05).astype(np.float32)
    return np.maximum(np.maximum(m, m.T), np.eye(d, dtype=np.float32))


def phase_dense_mix(w):
    """dense_mix against its plain version at the har width and at the
    edges of its 128 × 128 tile, bit for bit (one fused multiply-add per
    device in device order, in both), and against torch.mm (TF32 off) as
    the library's time."""
    import numpy as np
    import torch

    from repro_torch.kernels import dense_mix, dense_mix_plain

    d = w.shape[0]
    e = w[0].numel()
    m = dense_mask(d)
    mt = torch.as_tensor(m, device="cuda")
    wf = w.view(d, -1)
    got, want = dense_mix(w, m), dense_mix_plain(w, m)
    mism = mismatches(got, want)
    lib_rel = rel_err((torch.mm(mt, wf).view_as(want),), (want,))[1][0]
    flops, nbytes = 2 * d * d * e, 4 * (d * d + 2 * d * e)
    r = dict(abs=float((got - want).abs().max()), rels={}, flops=flops, nbytes=nbytes,
             ms=cuda_ms(lambda: dense_mix(w, m), 20),
             plain_ms=cuda_ms(lambda: dense_mix_plain(w, m), 1),
             library_ms=cuda_ms(lambda: torch.mm(mt, wf), 20))
    kernel_ms = device_ms(lambda: dense_mix(w, m), 10, ("transpose_kernel", "dense_mix_kernel"))
    b = bound(flops, nbytes)
    log(f"  dense_mix (D={d}, {int(m.sum())} ones): mismatches {mism}  ms={r['ms']:.4f}"
        f" (kernel alone {ms_text(kernel_ms)})"
        f" plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f}"
        f" ({library_device(lambda: torch.mm(mt, wf), 10)};"
        f" torch.mm against the plain version: max_rel={lib_rel:.3e})"
        f"  bound_ms={b[0]:.4f} ({b[1]}, {flops / 1e9:.2f} GFLOP)")
    assert mism == 0, f"dense_mix: {mism} elements differ from the plain version"
    # the 128 × 128 tile's edges, bit for bit: D off the tile with F % 4 ≠ 0
    # (the 4-byte path), D short of two tiles with F % 4 = 0, and x a view 4
    # bytes into its storage (the 4-byte path at F % 4 = 0)
    rng = np.random.default_rng(SEED + 3)
    for (dd, rr, cc), offset in (((13, 10, 37), 0), ((130, 7, 9), 0), ((200, 16, 23), 0),
                                 ((40, 8, 16), 1)):
        flat = torch.from_numpy(
            rng.standard_normal(dd * rr * cc + offset).astype(np.float32)).cuda()
        xe = flat[offset:].view(dd, rr, cc)
        me = (rng.random((dd, dd)) < 0.3).astype(np.float32)
        mism_e = mismatches(dense_mix(xe, me), dense_mix_plain(xe, me))
        log(f"  dense_mix D={dd} F={rr * cc}{' (4-byte offset)' if offset else ''}:"
            f" mismatches {mism_e}")
        assert mism_e == 0, f"dense_mix D={dd}: {mism_e} elements differ from the plain version"
    return r


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


def runtime_config(topology, precision="f32", merge_every=4, **hardened):
    """The phase's runtime; ``hardened`` takes ``robust=`` and ``faults=``
    (and ``staleness=``)."""
    from repro_torch.runtime import DetectorConfig, GovernorConfig, RuntimeConfig

    return RuntimeConfig(
        topology=topology, ridge=RIDGE,
        detector=DetectorConfig(warmup=5, warmup_skip=1, rel_sigma=0.05),
        governor=GovernorConfig(merge_every=merge_every), payload_precision=precision,
        **hardened,
    )


def fault_injector(d: int):
    """The ``adversarial`` preset's attack (×−25 on a seeded 10 % of the
    devices, from tick 0), a device whose payload is NaN on the rounds at
    ticks 7 and 15, and a device down for ticks 4-11."""
    from repro_torch.fleet import FaultInjector, FaultSpec

    return FaultInjector((
        FaultSpec(kind="scale", frac=0.1, magnitude=-25.0, seed=7),
        FaultSpec(kind="nan", devices=(5,), start_tick=7, period=8),
        FaultSpec(kind="crash", devices=(9,), start_tick=4, end_tick=12),
    ), d, seed=SEED)


def drive(fleet, ticks_dev, config, *, finite=True):
    """One runtime over every tick, its launch counts set to 0 after the
    warmup and read at the end; also the count of robust-quarantined
    devices after each tick."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import FleetRuntime

    rt = FleetRuntime(fleet, config, device="cuda")
    rt.warmup(T)
    reset_launch_counts()
    tick_ms, reports, quarantined = [], [], []
    for t in range(TICKS):
        t0 = time.perf_counter()
        reports.append(rt.tick(ticks_dev[t]))
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        quarantined.append(int(rt.governor.robust_quarantined.sum()))
    counts = launch_counts()
    if finite:
        assert bool(torch.isfinite(rt.states.p).all() and torch.isfinite(rt.states.beta).all())
    return rt, reports, tick_ms, counts, quarantined


def phase_end_to_end(fleet, ticks_dev, shifted):
    """The port's FleetRuntime at the har width on every topology, f32 and
    then int8 payloads."""
    import numpy as np

    from repro_torch.fleet import payload_precision_nbytes

    totals, p50 = {}, {}
    for precision in ("f32", "int8"):
        names = topologies(D) if precision == "f32" else INT8_TOPOLOGIES
        for name in names:
            rt, reports, tick_ms, counts, _ = drive(
                fleet, ticks_dev, runtime_config(topologies(D)[name], precision))
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


HARD_ROUTES = {
    "star": ("fleet_ingest", "robust_segment_sum_mix"),
    "hierarchical": ("fleet_ingest", "robust_segment_sum_mix"),
    "all_to_all": ("fleet_ingest", "robust_segment_sum_mix"),
    "ring": ("fleet_ingest",),   # the open ring trims by gather and sort, no kernel
    "custom_dense": ("fleet_ingest", "dense_mix", "from_uv_solve"),
    "star naive": ("fleet_ingest", "masked_segment_sum_mix", "from_uv_solve"),
}


def phase_hardened(fleet, ticks_dev, shifted):
    """The hardened FleetRuntime at the har width: the robust merge (trim 1;
    trim 0 on the custom dense mask, which has no neighbourhood to trim in)
    on five topologies and the naive merge on star, each beside a clean run
    (no faults, exact merge) of the same topology."""
    import numpy as np

    from repro_torch.fleet import RobustConfig, Topology

    injector = fault_injector(D)
    byzantine = np.zeros(D, bool)
    byzantine[list(injector.byzantine_devices)] = True
    honest = ~byzantine & ~shifted
    log(f"  faults: {len(injector.byzantine_devices)} Byzantine devices"
        f" {list(injector.byzantine_devices)}, NaN device 5, crashed device 9")
    topos = {k: v for k, v in topologies(D).items()
             if k in ("star", "hierarchical", "all_to_all", "ring")}
    topos["custom_dense"] = Topology(name="custom_dense", n_devices=D, kind="dense",
                                     matrix=dense_mask(D))
    runs = [(k, t, RobustConfig(trim=0 if k == "custom_dense" else 1)) for k, t in topos.items()]
    runs.append(("star naive", topos["star"], None))
    totals = {}
    for label, topo, robust in runs:
        clean = drive(fleet, ticks_dev, runtime_config(topo))[0]
        rt, reports, tick_ms, counts, quarantined = drive(
            fleet, ticks_dev, runtime_config(topo, robust=robust, faults=injector),
            finite=robust is not None)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        rounds = [t for t, r in enumerate(reports) if r.decision.merge]
        merge_ms = [reports[t].merge_seconds * 1e3 for t in rounds]
        ref = clean.states.beta[honest]
        dist = ((rt.states.beta[honest] - ref).flatten(1).norm(dim=1)
                / ref.flatten(1).norm(dim=1)).cpu().numpy()
        log(f"  hardened {label:13s} tick_ms p50={np.median(tick_ms):.2f} max={max(tick_ms):.2f}"
            f"  merge_ms p50={np.median(merge_ms):.2f} rounds at ticks {rounds}"
            f" participants {[reports[t].decision.participants for t in rounds]}"
            f" nonfinite {[reports[t].nonfinite_payloads for t in rounds]}"
            f" quarantined {[quarantined[t] for t in rounds]}")
        log(f"    honest devices' |β - clean β| / |clean β|: median {np.median(dist):.3e}"
            f" max {np.max(dist):.3e}  launches={counts}")
        log("    each honest device's: " + np.array2string(
            dist, precision=2, max_line_width=1 << 20, threshold=1 << 20))
        assert len(rounds) >= 2, f"hardened {label}: fewer than two admitted merges"
        assert sum(reports[t].nonfinite_payloads for t in rounds) > 0, "the NaN fault went unseen"
        for kernel in HARD_ROUTES[label]:
            assert counts[kernel] > 0, f"hardened {label}: {kernel} was never launched"
        trims = robust is not None and robust.trim > 0 and label != "ring"
        assert counts["robust_segment_sum_mix"] == (len(rounds) if trims else 0), (
            f"hardened {label}: robust_segment_sum_mix launched "
            f"{counts['robust_segment_sum_mix']} times in {len(rounds)} rounds")
        assert counts["dense_mix"] == (len(rounds) if label == "custom_dense" else 0), (
            f"hardened {label}: dense_mix launched {counts['dense_mix']} times in "
            f"{len(rounds)} rounds")
        if robust is not None:
            assert quarantined[-1] > 0, f"hardened {label}: no device was quarantined"
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
    phase_card_vs_cpu_hardened(small, small_cpu, ticks_np)


def phase_card_vs_cpu_hardened(small, small_cpu, ticks_np):
    """The hardened runtime (phase 3's faults) at D_CPU on the CPU and on
    the card: flags, decisions, non-finite counts and the robust quarantine
    equal after every tick, scores and losses within bounds. The trim is
    chosen so the attack is contained and the models stay well posed, as
    two runs of a garbage model part at rounding amplified without bound:
    on star 2 per side, as many as the fault has attackers in a 16-device
    fleet (with trim 1 the merged model is garbage, losses ~1e6); on the
    ring 1, as each ±2 neighbourhood holds at most one attacker (trim 2
    leaves each coordinate the median of five, whose PSD repair is ill
    conditioned)."""
    import numpy as np

    from repro_torch.fleet import RobustConfig
    from repro_torch.runtime import FleetRuntime

    for name, trim in (("star", 2), ("ring", 1)):
        topo = topologies(D_CPU)[name]
        card, cpu = (FleetRuntime(f, runtime_config(topo, robust=RobustConfig(trim=trim),
                                                    faults=fault_injector(D_CPU)), device=dev)
                     for f, dev in ((small, "cuda"), (small_cpu, "cpu")))
        worst, worst_score, merges, nonfinite, quarantined = 0.0, 0.0, 0, [], []
        for t in range(TICKS):
            batch = np.ascontiguousarray(ticks_np[t, :D_CPU])
            a, b = card.tick(batch), cpu.tick(batch)
            rtol = LOSS_RTOL if not merges else HARD_LOSS_RTOL
            np.testing.assert_allclose(a.losses, b.losses, rtol=rtol, atol=LOSS_ATOL)
            assert np.array_equal(a.drifted, b.drifted), f"hardened {name} tick {t}: drifted"
            assert np.array_equal(a.fresh_detections, b.fresh_detections)
            da, db = a.decision, b.decision
            assert (da.merge, da.participants, da.round_bytes) == (
                db.merge, db.participants, db.round_bytes)
            assert a.nonfinite_payloads == b.nonfinite_payloads
            assert np.array_equal(card.governor.robust_quarantined,
                                  cpu.governor.robust_quarantined), f"hardened {name} tick {t}"
            worst = max(worst, float(np.max(np.abs(a.losses - b.losses) / np.abs(b.losses))))
            if da.merge:
                merges += 1
                np.testing.assert_allclose(a.robust_scores, b.robust_scores, rtol=SCORE_RTOL,
                                           atol=SCORE_ATOL)
                worst_score = max(worst_score, float(np.max(
                    np.abs(a.robust_scores - b.robust_scores) / (1 + np.abs(b.robust_scores)))))
                nonfinite.append(a.nonfinite_payloads)
                quarantined.append(np.flatnonzero(card.governor.robust_quarantined).tolist())
        assert merges >= 2 and sum(nonfinite) > 0
        log(f"  hardened {name} trim {trim}: {TICKS} ticks at D={D_CPU}, losses max rel diff"
            f" {worst:.3e}"
            f" (rtol {LOSS_RTOL:.0e}, after a merge {HARD_LOSS_RTOL:.0e}), scores max rel diff"
            f" {worst_score:.3e}; merges {merges}, nonfinite per round {nonfinite},"
            f" quarantined per round {quarantined}: equal")


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
    phase_adversarial()


def phase_adversarial():
    """run_scenario on the adversarial preset (har with a ×−25 scale attack
    on 10 % of the devices; the robust merge by default), ring and star,
    on the card and on the CPU: merges, comm bytes, detections, every
    round's participants and non-finite payloads, and the robust
    quarantine after every round equal; scores and AUCs within bounds."""
    import numpy as np

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import GovernorConfig, MergeGovernor
    from repro_torch.scenarios import make_scenario, run_scenario, scenario_topology

    spec = make_scenario("adversarial")
    sc = spec.build()

    def quarantines(res, topo):
        """The governor's robust quarantine after each round, replayed from
        the round's scores as the runtime feeds them."""
        gov = MergeGovernor(scenario_topology(topo, spec.n_devices), spec.n_hidden,
                            sc.n_features, GovernorConfig(), robust=res.robust)
        out = []
        for r in res.reports:
            if r.decision.merge:
                gov.observe_robust(r.robust_scores)
                out.append(np.flatnonzero(gov.robust_quarantined).tolist())
        return out

    for topo in ("ring", "star"):
        reset_launch_counts()
        t0 = time.perf_counter()
        card = run_scenario(spec, topo, scenario=sc, device="cuda")
        card_s = time.perf_counter() - t0
        counts = launch_counts()
        cpu = run_scenario(spec, topo, scenario=sc, device="cpu")
        local = float(np.abs(card.local_aucs - cpu.local_aucs).max())
        merged = float(np.abs(card.merged_aucs - cpu.merged_aucs).max())
        clean = card.clean_devices
        q_card, q_cpu = quarantines(card, topo), quarantines(cpu, topo)
        det = card.detection
        log(f"  adversarial {topo:4s} {card_s:5.2f} s: robust {card.robust}; Byzantine devices"
            f" {list(spec.fault_devices())}; local AUC mean {card.local_aucs.mean():.4f},"
            f" merged {card.merged_aucs.mean():.4f}, honest clean devices merged"
            f" {card.merged_aucs[clean].mean():.4f}; merges {card.merges}, comm bytes"
            f" {card.comm_bytes}; detections: delays {det['delays']} missed {det['missed']}"
            f" false positives {det['false_positives']}; quarantined per round {q_card};"
            f" card - CPU AUC max |diff| local {local:.2e} merged {merged:.2e}; launches {counts}")
        assert card.robust is not None and card.robust == cpu.robust
        assert (card.merges, card.comm_bytes) == (cpu.merges, cpu.comm_bytes)
        assert card.detection == cpu.detection, f"adversarial {topo}: detections"
        assert q_card == q_cpu, f"adversarial {topo}: quarantines {q_card} against {q_cpu}"
        assert any(q_card), f"adversarial {topo}: no device was ever quarantined"
        for a, b in zip(card.reports, cpu.reports):
            assert a.decision.participants == b.decision.participants
            assert a.nonfinite_payloads == b.nonfinite_payloads
            if b.decision.merge:
                np.testing.assert_allclose(a.robust_scores, b.robust_scores, rtol=SCORE_RTOL,
                                           atol=SCORE_ATOL)
        assert max(local, merged) <= AUC_TOL["f32"], (
            f"adversarial {topo}: AUCs differ by {max(local, merged):.2e}")
        routed = ("fleet_ingest",) + (("robust_segment_sum_mix",) if topo == "star" else ())
        for kernel in routed:
            assert counts[kernel] > 0, f"adversarial {topo}: {kernel} was never launched"


def phase_profile(fleet, ticks_dev):
    """Where a tick's time goes: ticks 1–7 (merges at 3 and 7) under
    torch.profiler, after a first tick outside the window; f32 on star and
    ring, and the hardened runtime (phase 3's faults, robust trim 1) on
    star and ring."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fleet import RobustConfig
    from repro_torch.runtime import FleetRuntime

    hard = dict(robust=RobustConfig(trim=1), faults=fault_injector(D))
    for name, kw in (("star", {}), ("ring", {}), ("star", hard), ("ring", hard)):
        if kw:
            name = f"{name} hardened"
        rt = FleetRuntime(fleet, runtime_config(topologies(D)[name.split()[0]], **kw),
                          device="cuda")
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


# ------------------------------------------------ phase 7: the device path

# the k=1 chain, card against CPU, as max |card − CPU| / max |CPU| of P and
# of β after 256 steps at the har width: the reference's own spread between
# its kernel path and its XLA path on the same chain, measured by
# tests/test_torch_ops.py (8.4e-4 on P, 6.7e-3 on β; κ(P) ~ 2e7), where the
# port's CPU chain strays from the reference's kernel path by 1.2e-4 / 3.5e-4
CHAIN_TOL = {"P": 8e-4, "beta": 6e-3}
CHAIN_STEPS, PROFILE_STEPS = 256, 200
# the GEMM kernels against their plain versions: each sums in a fixed order
# of its own, the plain version is a PyTorch product, so they differ by
# rounding, which scales with the sum of the terms' magnitudes, |A|ᵀ|B|
# (|x|·|α| + |b| under hidden_proj's activation). max |kernel − plain| is
# held at 1e-6 of the largest of those: with the boot's P of a sigmoid
# device (κ ~ 1e8) P·h cancels to 3.4e-4 of max |P·h| in any two orders
GEMM_TOL = 1e-6


def core_kernel_rows():
    """hidden_proj, matmul_atb, rank1_add and the k=1 step's tail
    (k1_update, counted as rank1_add) against their plain versions on the
    card, at the shapes of the k=1 step and of the E²LM statistics at the
    har width (n = m = 561, 512 samples), Ñ = 64 and 128, identity and
    sigmoid; rank1_add and k1_update bit for bit, k1_update also at odd
    widths. The kernel list carries Ñ = 128, identity (the har config) at
    the k=1 shapes: hidden_proj of one sample, matmul_atb of h against P,
    and k1_update beside two torch.addr calls as its library time."""
    import numpy as np
    import torch

    from repro_torch.core import init_autoencoder
    from repro_torch.kernels import (
        hidden_proj, hidden_proj_plain, k1_update, k1_update_plain, matmul_atb,
        matmul_atb_plain, rank1_add, rank1_add_plain,
    )
    from repro_torch.kernels.matmul_atb import split_plan

    rng = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(rng.uniform(0, 1, (512, N_FEAT)).astype(np.float32)).cuda()
    rows, errs = {}, {"hidden_proj": 0.0, "matmul_atb": 0.0, "rank1_add": 0.0}

    def proj_kernels(m, n_out, k=N_FEAT):
        """The kernels one hidden_proj call launches: the k=1 kernel up to
        four rows, else the split kernel and, past one slice, its reduce."""
        if m <= 4:
            return ("proj_k1_kernel",)
        return ("proj_split_kernel",) + (
            ("proj_reduce_kernel",) if split_plan(1, k, m, n_out)[1] > 1 else ())

    def row(name, label, fn, plain, flops, nbytes, library=None, kernels=None, keep=False,
            scale=None):
        got, want = fn(), plain()
        if name == "rank1_add":  # one output, or k1_update's two
            pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
            abs_e = max(float((g - w).abs().max()) for g, w in pairs)
            mism = sum(mismatches(g, w) for g, w in pairs)
            assert mism == 0, f"rank1_add {label}: {mism} elements differ from the plain version"
            check = f"mismatches {mism}"
        else:
            abs_e = float((got - want).abs().max())
            assert torch.equal(fn(), got), f"{name} {label}: two calls differ"
            assert bool(torch.isfinite(got).all()), f"{name} {label}: non-finite output"
            rel = abs_e / scale
            assert rel <= GEMM_TOL, f"{name} {label}: max err / max |A|ᵀ|B| {rel:.3e}"
            check = (f"max err / max |A|ᵀ|B| {rel:.3e} (tol {GEMM_TOL:.0e}),"
                     f" / max |plain| {abs_e / float(want.abs().max()):.3e}"
                     + ", two calls bit-identical")
        errs[name] = max(errs[name], abs_e)
        r = dict(abs=abs_e, rels={}, flops=flops, nbytes=nbytes, ms=cuda_ms(fn, 200),
                 plain_ms=cuda_ms(plain, 20),
                 library_ms=cuda_ms(library, 200) if library is not None else None)
        alone = device_ms(fn, 50, kernels) if kernels else None
        b = r["bound_ms"], r["bound_by"] = bound(flops, nbytes)
        log(f"  {name} {label}: {check}  ms={r['ms']:.4f}"
            + (f" (kernel alone {ms_text(alone)})" if kernels else "")
            + f" plain_ms={r['plain_ms']:.4f} library_ms="
            + (f"{r['library_ms']:.4f} ({library_device(library, 50)})"
               if r["library_ms"] is not None else "None")
            + f"  bound_ms={b[0]:.6f} ({b[1]})")
        if keep:
            rows[name] = r

    for nh in (64, 128):
        for act in ("identity", "sigmoid"):
            st = init_autoencoder(torch.Generator().manual_seed(SEED), N_FEAT, nh, x[:4 * nh],
                                  activation=act, ridge=RIDGE, device="cuda")
            a, b = st.params.alpha, st.params.bias
            main = nh == 128 and act == "identity"
            tag = f"Ñ={nh} {act}"
            for m in (1, 512):
                xm = x[:m]
                mag = float((xm.abs() @ a.abs() + b.abs()).max())
                row("hidden_proj", f"{tag} x {m}x{N_FEAT}",
                    lambda: hidden_proj(xm, a, b, activation=act),
                    lambda: hidden_proj_plain(xm, a, b, activation=act),
                    2 * m * N_FEAT * nh, 4 * (m * N_FEAT + N_FEAT * nh + nh + m * nh),
                    library=(lambda: torch.addmm(b, xm, a)) if act == "identity" else None,
                    kernels=proj_kernels(m, nh),
                    keep=main and m == 1, scale=mag)
            h1 = hidden_proj(x[:1], a, b, activation=act)[0]
            hcol = h1[:, None].contiguous()
            row("matmul_atb", f"{tag} h^T P ({nh}x1, {nh}x{nh})",
                lambda: matmul_atb(hcol, st.p), lambda: matmul_atb_plain(hcol, st.p),
                2 * nh * nh, 4 * (nh + nh * nh + nh),
                library=lambda: torch.mm(hcol.T, st.p), kernels=("gemm_skinny_kernel",),
                keep=main,
                scale=float((hcol.abs().T @ st.p.abs()).max()))
            hb = hidden_proj(x, a, b, activation=act)
            for label, rhs in ((f"U = H^T H (512x{nh})", hb),
                               (f"V = H^T X (512x{nh}, 512x{N_FEAT})", x)):
                mcols = rhs.shape[1]
                row("matmul_atb", f"{tag} {label}",
                    lambda rhs=rhs: matmul_atb(hb, rhs), lambda rhs=rhs: matmul_atb_plain(hb, rhs),
                    2 * 512 * nh * mcols, 4 * (512 * nh + 512 * mcols + nh * mcols),
                    library=lambda rhs=rhs: torch.mm(hb.T, rhs),
                    kernels=("atb_split_kernel",) + (
                        ("atb_reduce_kernel",) if split_plan(1, 512, nh, mcols)[1] > 1 else ()),
                    scale=float((hb.abs().T @ rhs.abs()).max()))
            ph = matmul_atb(hcol, st.p)[0]
            denom = 1.0 + h1 @ ph
            err = x[0] - h1 @ st.beta
            for label, xx, v, sc in (("P", st.p, ph, -1.0 / denom),
                                     ("beta", st.beta, err, 1.0 / denom)):
                n1, n2 = xx.shape
                s_host = float(sc)
                row("rank1_add", f"{tag} on {label} ({n1}x{n2})",
                    lambda xx=xx, v=v, sc=sc: rank1_add(xx, ph, v, sc),
                    lambda xx=xx, v=v, sc=sc: rank1_add_plain(xx, ph, v, sc),
                    2 * n1 * n2 + n1, 4 * (2 * n1 * n2 + n1 + n2 + 1),
                    library=lambda xx=xx, v=v, s_host=s_host: torch.addr(xx, ph, v, alpha=s_host),
                    kernels=("rank1_kernel",))
            # the step's tail in one launch: both reductions, both scales and
            # both updates; its library time is the two torch.addr calls
            m_out = st.beta.shape[1]
            sp, sb = float(-1.0 / denom), float(1.0 / denom)
            row("rank1_add", f"{tag} k1_update (P {nh}x{nh}, beta {nh}x{m_out})",
                lambda: k1_update(st.p, st.beta, h1, ph, x[0]),
                lambda: k1_update_plain(st.p, st.beta, h1, ph, x[0]),
                2 * nh * nh + 4 * nh * m_out + 4 * nh,
                4 * (2 * nh * nh + 2 * nh * m_out + 2 * nh + m_out),
                library=lambda: (torch.addr(st.p, ph, ph, alpha=sp),
                                 torch.addr(st.beta, ph, err, alpha=sb)),
                kernels=("k1_kernel",), keep=main)
    # k1_update at odd widths and past the 256 rows a β strip keeps in
    # shared memory, bit for bit
    for nh, m in ((37, 23), (129, 64), (300, 561)):
        g = np.random.default_rng(SEED + nh)
        args = [torch.from_numpy(g.standard_normal(shape).astype(np.float32)).cuda()
                for shape in ((nh, nh), (nh, m), (nh,), (nh,), (m,))]
        mism = sum(mismatches(a, b) for a, b in zip(k1_update(*args), k1_update_plain(*args)))
        log(f"  k1_update Ñ={nh} m={m}: mismatches {mism}")
        assert mism == 0, f"k1_update Ñ={nh}: {mism} elements differ from the plain version"
    # hidden_proj at the edges of its split and k=1 kernels: K shorter than
    # a slice, K ending in a partial stage, 5 rows, 513 rows and 129
    # columns, K shorter than the cluster's 8 blocks, 4 rows; f32 and bf16
    for (m, k, n), dtype in itertools.product(
            ((64, 40, 128), (64, 100, 128), (5, 561, 128), (513, 561, 129), (1, 5, 128),
             (4, 561, 200)), (torch.float32, torch.bfloat16)):
        g = np.random.default_rng(SEED + 4)
        xe, ae, be = (torch.from_numpy(g.standard_normal(shape).astype(np.float32)).cuda()
                      .to(dtype) for shape in ((m, k), (k, n), (n,)))
        got = hidden_proj(xe, ae, be, activation="tanh")
        want = hidden_proj_plain(xe, ae, be, activation="tanh")
        mag = float((xe.float().abs() @ ae.float().abs() + be.float().abs()).max())
        rel = float((got - want).abs().max()) / mag
        same = torch.equal(hidden_proj(xe, ae, be, activation="tanh"), got)
        log(f"  hidden_proj edge {m}x{k}x{n} {str(dtype)[6:]} tanh"
            f" ({'+'.join(proj_kernels(m, n, k))}):"
            f" max err / max |x||α|+|b| {rel:.3e} (tol {GEMM_TOL:.0e}), two calls"
            f" {'bit-identical' if same else 'DIFFER'}")
        assert rel <= GEMM_TOL and same, f"hidden_proj {m}x{k}x{n} {dtype}"
    # each activation applied once, to the finished sum: G of the kernel's
    # own identity output, whose slice sums are the same bits
    from repro_torch.core.activations import ACTIVATION_CODES, get_activation

    st = init_autoencoder(torch.Generator().manual_seed(SEED), N_FEAT, N_HID, x[:4 * N_HID],
                          activation="identity", ridge=RIDGE, device="cuda")
    for m in (1, 512):
        pre = hidden_proj(x[:m], st.params.alpha, st.params.bias, activation="identity")
        worst = max(float((hidden_proj(x[:m], st.params.alpha, st.params.bias, activation=act)
                           - get_activation(act)(pre)).abs().max()) for act in ACTIVATION_CODES)
        scale = max(1.0, float(pre.abs().max()))
        log(f"  hidden_proj {m}x{N_FEAT}: every activation against G(identity output):"
            f" max err {worst:.3e} (tol {GEMM_TOL * scale:.1e})")
        assert worst <= GEMM_TOL * scale, f"hidden_proj {m} rows: G not applied once"
    # the Eq. 13 boot's statistics at 512 samples: one hidden_proj, two matmul_atb
    from repro_torch.kernels import uv_from_batch_kernel

    def boot():
        return uv_from_batch_kernel(st.params.alpha, st.params.bias, x, x, activation="identity")

    log(f"  Eq. 13 boot statistics (512x{N_FEAT}, Ñ={N_HID}): ms={cuda_ms(boot, 100):.4f}"
        f" ({call_device(boot, 50, 'device')})")
    for name in rows:
        rows[name]["abs"] = errs[name]
    return rows


def counted(what, expected):
    """Launch counts of the three core kernels since the last reset, held
    to the calls ``what`` made: {kernel: calls}."""
    from repro_torch.kernels import launch_counts

    counts = launch_counts()
    got = {k: counts[k] for k in expected}
    log(f"    launches in {what}: {got}")
    assert got == expected, f"{what}: launches {got}, expected {expected}"
    return counts


def exact_score_distance(state, train, pattern, key, ecfg, seed, x_eval):
    """Largest relative distance of a trained device's scores from those
    of the exact ridge solution (f64, on all of the device's rows, which
    its RLS chain equals in exact arithmetic)."""
    import numpy as np
    import torch

    from repro_torch.core import ae_score, init_slfn
    from repro_torch.data import make_pattern_stream

    xs = make_pattern_stream(train, pattern, seed=seed).astype(np.float64)
    params = init_slfn(torch.Generator().manual_seed(key), xs.shape[1], ecfg.n_hidden,
                       device="cpu")
    alpha, bias = params.alpha.double().numpy(), params.bias.double().numpy()
    n_init = min(max(2 * ecfg.n_hidden, 8), max(len(xs) - 8, len(xs) // 2))
    ridge = max(ecfg.ridge, 1e-2 if n_init < 2 * ecfg.n_hidden else ecfg.ridge)
    h = xs @ alpha + bias
    beta = np.linalg.solve(h.T @ h + ridge * np.eye(ecfg.n_hidden), h.T @ xs)
    xe = x_eval.astype(np.float64)
    exact = np.mean((xe - (xe @ alpha + bias) @ beta) ** 2, axis=1)
    got = ae_score(state, torch.as_tensor(x_eval, device=state.device)).cpu().numpy()
    return float(np.max(np.abs(got - exact) / exact))


def f64_merged_losses(a, b, test, limit):
    """pattern_loss_rows' A_after column for the cooperative update of two
    CPU states taken in f64."""
    import numpy as np

    def uv(state):
        u = np.linalg.inv(state.p.double().numpy())
        u = 0.5 * (u + u.T)
        return u, u @ state.beta.double().numpy()

    (ua, va), (ub, vb) = uv(a), uv(b)
    beta = np.linalg.solve(ua + ub, va + vb)
    alpha, bias = a.params.alpha.double().numpy(), a.params.bias.double().numpy()
    out = {}
    for pat in test.class_names:
        x = test.pattern(pat)[:limit].astype(np.float64)
        out[pat] = float(np.mean((x - (x @ alpha + bias) @ beta) ** 2))
    return out


def phase_device_path():
    """The paper's single-device path at the har width (n = m = 561,
    Ñ = 128, identity, ridge 1e-3): (a) the three core kernels against
    their plain versions; (b) a 256-step k=1 chain, card against CPU;
    (c) two devices trained with train_edge_device, pair_merge_eval and
    pattern_loss_rows, Fig. 18's sequential arm and Table 4's rows, card
    against CPU where there is something to compare; (d) launch counts of
    each part equal to its calls; (e) torch.profiler over 200 k=1 steps.
    Returns the kernel rows and the launches of (b) and (c)."""
    import numpy as np
    import torch

    from benchmarks import torch_convergence, torch_latency
    from benchmarks.torch_common import edge_config, normalized_dataset, train_edge_device
    from repro_torch.core import ae_train_step
    from repro_torch.data import make_pattern_stream, train_test_split
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.scenarios import pair_merge_eval, pattern_loss_rows

    log("  (a) the core kernels against their plain versions")
    rows = core_kernel_rows()
    totals = {k: 0 for k in ("hidden_proj", "matmul_atb", "rank1_add")}

    def add(counts):
        for k in totals:
            totals[k] += counts[k]

    train, test = train_test_split(normalized_dataset("har", seed=SEED), 0.8, seed=SEED)
    ecfg = edge_config("har")
    dev_cpu = train_edge_device(train, "walking", key=SEED, ecfg=ecfg, seed=SEED + 1,
                                device="cpu")
    stream = make_pattern_stream(train, "laying", seed=SEED + 2)
    xs = np.concatenate([stream] * (CHAIN_STEPS // len(stream) + 1))[:CHAIN_STEPS]

    log(f"  (b) a {CHAIN_STEPS}-step k=1 chain at the har width, card against CPU")
    card = dev_cpu.replace(params=type(dev_cpu.params)(*(t.cuda() for t in dev_cpu.params)),
                           beta=dev_cpu.beta.cuda(), p=dev_cpu.p.cuda())
    xs_card, xs_cpu = torch.from_numpy(xs).cuda(), torch.from_numpy(xs)
    ae_train_step(card, xs_card[0])
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(CHAIN_STEPS):
        card = ae_train_step(card, xs_card[i])
    torch.cuda.synchronize()
    step_us = (time.perf_counter() - t0) / CHAIN_STEPS * 1e6
    add(counted("the chain", {"hidden_proj": CHAIN_STEPS, "matmul_atb": CHAIN_STEPS,
                              "rank1_add": CHAIN_STEPS}))
    cpu = dev_cpu
    for i in range(CHAIN_STEPS):
        cpu = ae_train_step(cpu, xs_cpu[i])
    _, rels = rel_err((card.p.cpu(), card.beta.cpu()), (cpu.p, cpu.beta))
    log(f"    {step_us:.2f} us per k=1 step (host clock, {CHAIN_STEPS} steps, one sync);"
        f" card against CPU after {CHAIN_STEPS} steps: P max_rel {rels[0]:.3e}"
        f" (tol {CHAIN_TOL['P']:.0e}), beta max_rel {rels[1]:.3e} (tol {CHAIN_TOL['beta']:.0e})")
    assert rels[0] <= CHAIN_TOL["P"] and rels[1] <= CHAIN_TOL["beta"], "k=1 chain: card != CPU"

    log("  (c) two devices, their cooperative update, Fig. 18 and Table 4")
    reset_launch_counts()
    devs = {dev: {pat: train_edge_device(train, pat, key=SEED, ecfg=ecfg, seed=SEED + i,
                                         device=dev)
                  for i, pat in enumerate(("laying", "walking"))} for dev in ("cuda", "cpu")}
    add(counted("two devices' training (two boots)", {"hidden_proj": 2, "matmul_atb": 4,
                                                      "rank1_add": 0}))
    x_eval = np.concatenate([test.pattern(p)[:32] for p in test.class_names])
    for pat in ("laying", "walking"):
        i = ("laying", "walking").index(pat)
        dist = {dev: exact_score_distance(devs[dev][pat], train, pat, SEED, ecfg, SEED + i, x_eval)
                for dev in devs}
        log(f"    {pat} device: scores' largest relative distance from the exact ridge"
            f" solution: card {dist['cuda']:.3e}, CPU {dist['cpu']:.3e}")
        # two f32 implementations of the boot (tests/test_torch_pair_eval.py:
        # the port's CPU path and the reference, 3.9e-3 and 6.7e-3)
        assert dist["cuda"] <= 3 * dist["cpu"], f"{pat}: the card's device strays"
    patterns = tuple(test.class_names.index(p) for p in ("laying", "walking"))
    a, b = devs["cuda"]["laying"], devs["cuda"]["walking"]
    a_cpu, b_cpu = (s.replace(params=type(s.params)(*(t.cpu() for t in s.params)),
                              beta=s.beta.cpu(), p=s.p.cpu()) for s in (a, b))
    for first, second, f_cpu, s_cpu, label in ((a, b, a_cpu, b_cpu, "A=laying"),
                                               (b, a, b_cpu, a_cpu, "A=walking")):
        auc_card = pair_merge_eval(first, second, test, patterns)
        auc_cpu = pair_merge_eval(f_cpu, s_cpu, test, patterns)
        own = pair_merge_eval(devs["cpu"][label[2:]], devs["cpu"]["walking" if label[2:] == "laying"
                                                                  else "laying"], test, patterns)
        log(f"    pair_merge_eval {label}: AUC before/after card {auc_card}, CPU on the card's"
            f" devices {auc_cpu}, CPU on its own devices {own}")
        assert np.max(np.abs(np.subtract(auc_card, auc_cpu))) <= AUC_TOL["f32"], label
    rows_card = pattern_loss_rows(a, b, test, limit=64)
    rows_cpu = pattern_loss_rows(a_cpu, b_cpu, test, limit=64)
    worst = {c: max(abs(rows_card[p][c] - rows_cpu[p][c]) / rows_cpu[p][c] for p in rows_cpu)
             for c in ("A_before", "B", "A_after")}
    log(f"    pattern_loss_rows card against CPU on the card's devices, max rel: {worst}")
    for p, r in rows_card.items():
        log(f"      {p:20s} " + " ".join(f"{c}={v:.6f}" for c, v in r.items()))
    assert worst["A_before"] <= 1e-5 and worst["B"] <= 1e-5
    # the merged model: each f32 merge (cuSOLVER on the card, LAPACK on the
    # CPU) is held to an f64 merge of the same two states. Here U = P⁻¹ is
    # taken of P with κ ~ 2e7 and the merged U has κ ~ 3e6, so the two f32
    # merges part by 3.5e-3 in these losses on an H100 (more than the 1e-3
    # between the two packages on the CPU at Ñ = 32); each is held within
    # 1e-2 of the f64 merge's losses.
    exact = f64_merged_losses(a_cpu, b_cpu, test, 64)
    dist = {dev: max(abs(r[p]["A_after"] - exact[p]) / exact[p] for p in exact)
            for dev, r in (("card", rows_card), ("CPU", rows_cpu))}
    log(f"    A_after, largest relative distance from the f64 merge: {dist}")
    assert max(dist.values()) <= 1e-2, "a merged model strays from the f64 merge"

    reset_launch_counts()
    conv = {dev: torch_convergence.run(seed=SEED, device=dev) for dev in ("cuda", "cpu")}
    c = conv["cuda"]
    add(counted("Fig. 18 on the card and the CPU", {
        "hidden_proj": c["boots"] + c["k1_steps"], "matmul_atb": 2 * c["boots"] + c["k1_steps"],
        "rank1_add": c["k1_steps"]}))
    log(f"    Fig. 18: crossover after {c['crossover_updates']} k=1 updates on the card,"
        f" {conv['cpu']['crossover_updates']} on the CPU; merge loss card {c['merge_loss']:.6e}"
        f" CPU {conv['cpu']['merge_loss']:.6e}; loss before {c['loss_before']:.6f};"
        f" curve card {c['curve']} CPU {conv['cpu']['curve']};"
        f" merge {c['merge_ms']:.4f} ms vs {c['crossover_updates']} sequential updates"
        f" {c['sequential_ms']:.3f} ms on the card")
    assert c["crossover_updates"] == conv["cpu"]["crossover_updates"], "Fig. 18 crossover"
    assert c["merge_loss"] < c["loss_before"] / 5

    reset_launch_counts()
    table = [torch_latency.run(nh, device="cuda") for nh in (64, 128)]
    add(counted("Table 4", {
        "hidden_proj": sum(r["oselm"]["boots"] + r["oselm"]["k1_steps"] for r in table),
        "matmul_atb": sum(2 * r["oselm"]["boots"] + r["oselm"]["k1_steps"] for r in table),
        "rank1_add": sum(r["oselm"]["k1_steps"] for r in table)}))
    for line in torch_latency.table_lines(table):
        log("    " + line)

    log(f"  (e) torch.profiler over {PROFILE_STEPS} k=1 steps")
    from torch.profiler import ProfilerActivity, profile

    st = card
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_STEPS):
            st = ae_train_step(st, xs_card[i])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    assert dev_ms > 0, "the profiler saw no device time"
    launches = sum(e.count for e in events)
    log(f"    {PROFILE_STEPS} k=1 steps: wall {wall_ms:.3f} ms, device {dev_ms:.3f} ms,"
        f" busy share {dev_ms / wall_ms:.3f}; {launches / PROFILE_STEPS:.2f} kernel launches a"
        f" step (profiler)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"      {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<5d} {e.key[:80]}")
    return rows, totals


# ------------------------------- phase 8: repeated synchronisation, stale merges

ROUNDS = 4   # fleet_train_rounds / fleet_train_async: 4 rounds of T samples
# card against CPU after ROUNDS rounds at D_CPU, as max |card − CPU| / max |CPU|
# of P and of β. tests/test_torch_fleet_rounds.py and
# tests/test_torch_staleness.py hold the port's chains to the reference's at
# twice the reference's own spread between the same chain with Gauss-Jordan
# merges and with Cholesky merges: a merge that rounds U's last bits
# otherwise moves the chain by about that much, as the next rounds amplify
# the difference by κ(U). Card and CPU round otherwise in every step (the
# ingest's sums, to_uv's Cholesky inverses, the merge), so each strays from
# a common exact chain by about its own such spread, and the two by up to
# the sum: here the card is held at twice the sum of the Gauss-Jordan-vs-
# Cholesky spreads measured on the card and on the CPU on the same inputs,
# and at least at twice the reference's spread on the tests' fixture
# (largest over the topologies: synchronous 3.6e-4 on P and 5.6e-4 on β,
# stale 1.3e-4 and 2.0e-4).
ROUNDS_TOL = {"P": 7.2e-4, "beta": 1.12e-3}
ASYNC_TOL = {"P": 2.7e-4, "beta": 3.9e-4}
# the mix kernel each topology's stale round launches (besides from_uv_solve)
STALE_ROUTES = {
    "star": ("segment_sum_mix",),
    "hierarchical": ("segment_sum_mix",),
    "hierarchical_isolated": ("segment_sum_mix", "segment_broadcast"),
    "all_to_all": ("dense_mix",),
    "ring": ("banded_mix",),
}
MIX_KERNELS = ("segment_sum_mix", "segment_broadcast", "banded_mix")


def async_schedule(d: int):
    from repro_torch.fleet import StalenessSchedule

    return StalenessSchedule.random(d, max_lag=3, seed=SEED, stragglers=0.1)


def mix_kernel_rows(fleet, topo_hier):
    """(a) the three mix kernels against their plain versions at the har
    width on the fleet's payloads, bit for bit: the plain versions sum in
    the kernels' order. The kernel list carries the hierarchy's shapes
    (C = D/8) and the ring's hops = 2."""
    import numpy as np
    import torch

    from repro_torch.fleet import fleet_to_uv
    from repro_torch.kernels import (
        banded_mix, banded_mix_plain, segment_broadcast, segment_broadcast_plain,
        segment_sum_mix, segment_sum_mix_plain,
    )

    uv = fleet_to_uv(fleet, ridge=RIDGE)
    w = torch.cat([uv.u, uv.v], dim=2).contiguous()
    del uv
    d, e = w.shape[0], w[0].numel()
    rows = {}

    def row(name, label, fn, plain, library, kernel, nbytes):
        got, want = fn(), plain()
        mism = mismatches(got, want)
        lib_mism = mismatches(library(), want) if library is not None else None
        r = dict(abs=float((got - want).abs().max()), rels={}, flops=0, nbytes=nbytes,
                 ms=cuda_ms(fn, 50), plain_ms=cuda_ms(plain, 2),
                 library_ms=cuda_ms(library, 50) if library is not None else None)
        alone = device_ms(fn, 20, (kernel,))
        b = r["bound_ms"], r["bound_by"] = bound(0, nbytes)
        log(f"  {name} {label}: mismatches {mism}"
            + (f" (library against plain: {lib_mism})" if lib_mism is not None else "")
            + f"  ms={r['ms']:.4f} (kernel alone {ms_text(alone)}) plain_ms={r['plain_ms']:.4f}"
            + " library_ms=" + (f"{r['library_ms']:.4f} ({library_device(library, 20)})"
                                if library is not None else "None")
            + f"  bound_ms={b[0]:.4f} ({b[1]}, {nbytes / 1e6:.1f} MB)")
        assert mism == 0, f"{name} {label}: {mism} elements differ from the plain version"
        return r

    zeros = np.zeros(d, np.int32)
    cids = topo_hier.cluster_ids
    n_cl = topo_hier.n_clusters
    cids_t = torch.as_tensor(cids, dtype=torch.long, device="cuda")
    # reads the payloads and writes the sums once (and the C+1 offsets)
    row("segment_sum_mix", "star (C=1)", lambda: segment_sum_mix(w, zeros, 1),
        lambda: segment_sum_mix_plain(w, zeros, 1), lambda: w.sum(0, keepdim=True),
        "segsum_kernel<false>", 4 * (d * e + e + 2))
    rows["segment_sum_mix"] = row(
        "segment_sum_mix", f"hierarchical (C={n_cl})", lambda: segment_sum_mix(w, cids, n_cl),
        lambda: segment_sum_mix_plain(w, cids, n_cl),
        lambda: torch.zeros((n_cl,) + tuple(w.shape[1:]), device="cuda").index_add_(0, cids_t, w),
        "segsum_kernel<false>", 4 * (d * e + n_cl * e + n_cl + 1))
    sums = segment_sum_mix(w, cids, n_cl)
    rows["segment_broadcast"] = row(
        "segment_broadcast", f"C={n_cl} -> {d}", lambda: segment_broadcast(sums, cids),
        lambda: segment_broadcast_plain(sums, cids), lambda: sums.index_select(0, cids_t),
        "segment_broadcast_kernel", 4 * (n_cl * e + d * e + d))
    # each payload read once and each sum written once; with no reuse of a
    # neighbour's payload between devices the reads are 2·hops+1 times as many.
    # The library call: torch.mm by the circular band's 0/1 D × D matrix
    idx = torch.arange(d, device="cuda")
    off = (idx[None, :] - idx[:, None]) % d
    band = ((off <= HOPS) | (off >= d - HOPS)).to(torch.float32)
    w2 = w.view(d, e)
    rows["banded_mix"] = r = row(
        "banded_mix", f"hops={HOPS}", lambda: banded_mix(w, HOPS), lambda: banded_mix_plain(w, HOPS),
        lambda: torch.mm(band, w2).view_as(w), "banded_mix_kernel", 4 * 2 * d * e)
    no_reuse = 4 * (2 * HOPS + 2) * d * e
    log(f"    banded_mix with {2 * HOPS + 1} reads of every payload: bound"
        f" {bound(0, no_reuse)[0]:.4f} ms ({no_reuse / 1e6:.1f} MB);"
        f" measured {r['ms']:.4f} ms moves {no_reuse / (r['ms'] * 1e-3) / 1e12:.2f} TB/s at that count")
    return rows


def timed_run(fn, what, expected):
    """Run ``fn`` with the launch counts set to 0 just before and read just
    after; hold each kernel of ``expected`` to its count and return
    (result, ms, counts)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    got = {k: counts[k] for k in expected}
    assert got == expected, f"{what}: launches {got}, expected {expected}"
    return out, ms, counts


def round_streams(ticks, d):
    """The first ROUNDS ticks of each device as one (d, ROUNDS·T, n) stream."""
    x = ticks[:ROUNDS, :d]
    return x.permute(1, 0, 2, 3).reshape(d, ROUNDS * T, N_FEAT).contiguous()


def phase_rounds(fleet, ticks_dev, totals):
    """(b) and (c): fleet_train_rounds and fleet_train_async at the har
    width on every topology, launches equal to the rounds routed to each
    kernel; lag 0 equal to the synchronous rounds bit for bit."""
    import torch

    from repro_torch.fleet import StalenessSchedule, fleet_train_async, fleet_train_rounds

    streams = round_streams(ticks_dev, D)
    sched = async_schedule(D)
    log(f"  lags: {sched.lags.tolist()}")
    sync = {}

    def add(counts):
        for k in MIX_KERNELS:
            totals[k] += counts[k]

    for name, topo in topologies(D).items():
        merge = {"ring": {"banded_merge_solve": ROUNDS, "from_uv_solve": 0}}.get(
            name, {"from_uv_solve": ROUNDS, "banded_merge_solve": 0})
        seg = ROUNDS if topo.kind == "segment" else 0
        sync[name], ms, counts = timed_run(
            lambda: fleet_train_rounds(fleet, streams, topo, rounds=ROUNDS, ridge=RIDGE),
            f"fleet_train_rounds {name}",
            {"fleet_ingest": ROUNDS, "segment_sum_mix": seg, "segment_broadcast": 0,
             "banded_mix": 0, **merge})
        add(counts)
        log(f"  (b) fleet_train_rounds {name:22s} {ms / ROUNDS:8.2f} ms per round;"
            f" launches {({k: v for k, v in counts.items() if v})}")
        routes = {k: ROUNDS if k in STALE_ROUTES[name] else 0
                  for k in MIX_KERNELS + ("dense_mix",)}
        stale, ms, counts = timed_run(
            lambda: fleet_train_async(fleet, streams, topo, sched, rounds=ROUNDS, ridge=RIDGE),
            f"fleet_train_async {name}",
            {"fleet_ingest": ROUNDS, "from_uv_solve": ROUNDS, "banded_merge_solve": 0, **routes})
        add(counts)
        assert bool(torch.isfinite(stale.p).all() and torch.isfinite(stale.beta).all())
        apart = rel_err((stale.beta,), (sync[name].beta,))[0]
        log(f"  (c) fleet_train_async  {name:22s} {ms / ROUNDS:8.2f} ms per round;"
            f" max |beta - synchronous beta| {apart:.3e}; launches"
            f" {({k: v for k, v in counts.items() if v})}")
        assert apart > 1e-6, f"{name}: the lags changed nothing"
    for name in ("star", "hierarchical_isolated", "ring"):
        zero = fleet_train_async(fleet, streams, topologies(D)[name], StalenessSchedule.uniform(D, 0),
                                 rounds=ROUNDS, ridge=RIDGE)
        same = torch.equal(zero.p, sync[name].p) and torch.equal(zero.beta, sync[name].beta)
        log(f"  (c) lag 0 on {name}: equal to fleet_train_rounds bit for bit: {same}")
        assert same, f"{name}: lag 0 is not the synchronous rounds"
    profile_rounds(fleet, streams, sched)


def profile_rounds(fleet, streams, sched):
    """Where a round's time goes: torch.profiler over ROUNDS synchronous and
    ROUNDS stale rounds on star and ring."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fleet import fleet_train_async, fleet_train_rounds

    for name in ("star", "ring"):
        topo = topologies(D)[name]
        for label, fn in (
            ("rounds", lambda: fleet_train_rounds(fleet, streams, topo, rounds=ROUNDS, ridge=RIDGE)),
            ("stale rounds", lambda: fleet_train_async(fleet, streams, topo, sched, rounds=ROUNDS,
                                                       ridge=RIDGE)),
        ):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            dev_ms = sum(e.self_device_time_total for e in events) / 1e3
            assert dev_ms > 0, "the profiler saw no device time"
            log(f"  (c) profile, {ROUNDS} {label} on {name}: wall {wall_ms:.2f} ms, device"
                f" {dev_ms:.2f} ms, busy share {dev_ms / wall_ms:.3f}")
            for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
                log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def phase_stale_runtime(fleet, ticks_dev, totals):
    """(d) the stale FleetRuntime at the har width on ring and isolated
    hierarchical: launches of each mix kernel equal to the admitted rounds."""
    import numpy as np

    sched = async_schedule(D)
    for name in ("ring", "hierarchical_isolated"):
        rt, reports, tick_ms, counts, _ = drive(
            fleet, ticks_dev, runtime_config(topologies(D)[name], staleness=sched))
        rounds = [r for r in reports if r.decision.merge]
        merge_ms = [r.merge_seconds * 1e3 for r in rounds]
        log(f"  (d) stale {name:22s} tick_ms p50={np.median(tick_ms):.2f} max={max(tick_ms):.2f}"
            f"  merge_ms p50={np.median(merge_ms):.2f}  merges={len(rounds)}"
            f" participants={[r.decision.participants for r in rounds]}"
            f" launches={({k: v for k, v in counts.items() if v})}")
        assert len(rounds) >= 2 and rt.merge_round == len(rounds)
        expected = {k: len(rounds) if k in STALE_ROUTES[name] else 0 for k in MIX_KERNELS}
        got = {k: counts[k] for k in MIX_KERNELS}
        assert got == expected, f"stale {name}: launches {got}, expected {expected}"
        assert counts["from_uv_solve"] == len(rounds) and counts["banded_merge_solve"] == 0
        for k in MIX_KERNELS:
            totals[k] += counts[k]


def cholesky_uv_solve(u, v, *, ridge=0.0):
    """P = (U+εI)⁻¹ and β = PV by Cholesky (``repro_torch.core``), as the
    reference solves its merges: the yardstick of a Gauss-Jordan chain."""
    from repro_torch.core.elm import invert_u, solve_beta

    return invert_u(u, ridge=ridge), solve_beta(u, v, ridge=ridge)


@contextlib.contextmanager
def cholesky_merges():
    """Within the block every merge of the fleet package solves by Cholesky:
    the open ring's fused merge becomes the banded mix and a Cholesky solve."""
    import repro_torch.fleet.fleet as ff
    import repro_torch.fleet.staleness as st
    from repro_torch.kernels import banded_mix

    def banded(w, hops, *, ridge=0.0):
        mixed = banded_mix(w, hops)
        n = w.shape[1]
        return cholesky_uv_solve(mixed[:, :, :n], mixed[:, :, n:], ridge=ridge)

    saved = (ff.from_uv_solve, ff.banded_merge_solve, st.from_uv_solve)
    ff.from_uv_solve, ff.banded_merge_solve, st.from_uv_solve = (
        cholesky_uv_solve, banded, cholesky_uv_solve)
    try:
        yield
    finally:
        ff.from_uv_solve, ff.banded_merge_solve, st.from_uv_solve = saved


def phase_rounds_card_vs_cpu(fleet, ticks_np):
    """(e) (b), (c) and (d) at D_CPU devices on the card and on the CPU;
    each chain beside its Cholesky twins on both, whose distances set the
    bound."""
    import numpy as np
    import torch

    from repro_torch.fleet import fleet_train_async, fleet_train_rounds
    from repro_torch.runtime import FleetRuntime

    small = fleet.replace(beta=fleet.beta[:D_CPU].contiguous(), p=fleet.p[:D_CPU].contiguous())
    small_cpu = small.replace(
        params=type(small.params)(*(x.cpu() for x in small.params)),
        beta=small.beta.cpu(), p=small.p.cpu(),
    )
    streams = round_streams(torch.from_numpy(ticks_np), D_CPU)
    sched = async_schedule(D_CPU)
    for name, topo in topologies(D_CPU).items():
        for label, fn, floor in (
            ("fleet_train_rounds", lambda f, x: fleet_train_rounds(
                f, x, topo, rounds=ROUNDS, ridge=RIDGE), ROUNDS_TOL),
            ("fleet_train_async", lambda f, x: fleet_train_async(
                f, x, topo, sched, rounds=ROUNDS, ridge=RIDGE), ASYNC_TOL),
        ):
            card, cpu = fn(small, streams.cuda()), fn(small_cpu, streams)
            with cholesky_merges():
                twin_card, twin_cpu = fn(small, streams.cuda()), fn(small_cpu, streams)
            _, rels = rel_err((card.p.cpu(), card.beta.cpu()), (cpu.p, cpu.beta))
            _, sp_card = rel_err((twin_card.p, twin_card.beta), (card.p, card.beta))
            _, sp_cpu = rel_err((twin_cpu.p, twin_cpu.beta), (cpu.p, cpu.beta))
            tol = [max(floor[k], 2 * (a + b)) for k, a, b in zip(("P", "beta"), sp_card, sp_cpu)]
            log(f"  (e) {label} {name:22s} at D={D_CPU}: card - CPU P max_rel {rels[0]:.3e},"
                f" beta {rels[1]:.3e}; Gauss-Jordan - Cholesky on the card P {sp_card[0]:.3e},"
                f" beta {sp_card[1]:.3e}, on the CPU P {sp_cpu[0]:.3e}, beta {sp_cpu[1]:.3e};"
                f" bounds {tol[0]:.3e}, {tol[1]:.3e}")
            assert rels[0] <= tol[0] and rels[1] <= tol[1], f"{label} {name}: card != CPU"
    # the stale runtime, held as tests/test_torch_staleness.py holds it
    # against the reference: losses at 2e-4 on every tick
    for name in ("ring", "hierarchical_isolated"):
        cfg = runtime_config(topologies(D_CPU)[name], staleness=sched)
        card = FleetRuntime(small, cfg, device="cuda")
        cpu = FleetRuntime(small_cpu, cfg, device="cpu")
        worst, merges = 0.0, 0
        for t in range(TICKS):
            batch = np.ascontiguousarray(ticks_np[t, :D_CPU])
            a, b = card.tick(batch), cpu.tick(batch)
            np.testing.assert_allclose(a.losses, b.losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
            assert np.array_equal(a.drifted, b.drifted), f"stale {name} tick {t}: drifted"
            assert np.array_equal(a.fresh_detections, b.fresh_detections)
            da, db = a.decision, b.decision
            assert (da.merge, da.participants, da.round_bytes) == (
                db.merge, db.participants, db.round_bytes), f"stale {name} tick {t}"
            worst = max(worst, float(np.max(np.abs(a.losses - b.losses) / np.abs(b.losses))))
            merges += da.merge
        assert merges >= 2
        log(f"  (e) stale FleetRuntime {name}: {TICKS} ticks at D={D_CPU}, losses max rel diff"
            f" {worst:.3e} (rtol {LOSS_RTOL:.0e}), merges {merges}: flags and decisions equal")


def phase_repeated_sync(fleet, ticks_dev, ticks_np):
    """Phase 8; returns the three mix kernels' rows and their launches over
    (b), (c) and (d)."""
    from repro_torch.fleet import hierarchical

    log("  (a) the three mix kernels against their plain versions")
    rows = mix_kernel_rows(fleet, hierarchical(D, D // 8))
    totals = dict.fromkeys(MIX_KERNELS, 0)
    phase_rounds(fleet, ticks_dev, totals)
    phase_stale_runtime(fleet, ticks_dev, totals)
    log(f"  launches of the mix kernels over (b), (c) and (d): {totals}")
    for k, v in totals.items():
        assert v > 0, f"{k} was never launched on the path"
    phase_rounds_card_vs_cpu(fleet, ticks_np)
    return rows, totals


# ------------------------------------------------ phase 9: serving hymba-1.5b

SERVE_ARCH = "hymba-1.5b"   # the reference's serving demo's default
SERVE = dict(rounds=3, batch=4, prompt_len=512, new_tokens=16, drift_round=2)
SERVE_LONG = 2048           # > the 1024-token window: local attention in 29 layers
SERVE_CPU_B, SERVE_CPU_S, SERVE_CPU_STEPS = 2, 256, 8
# kernel against plain on the card, as the largest over the rows (a query's
# output, a token's y, a row of the state) of max |kernel − plain| / max
# |plain| within the row, so that a late query row, whose values are a
# fraction of row 0's, counts as much as row 0. flash: f32 dot products in
# other orders (measured up to 4.3e-6 per row); bf16, a p or an output that
# rounds to the other neighbour (up to 7.8e-3 on the tensor cores, about one
# bf16 step of the row's largest entry). GLA's plain version repeats the
# kernels' arithmetic, its products summed in PyTorch's order (measured up to
# 1.5e-7 per row in f32; the bf16 rows equal): 1e-5 in f32, one bf16 step
# (2^-8) in bf16.
ATTN_TOL = {("flash_attention", "float32"): 1e-5, ("flash_attention", "bfloat16"): 2e-2,
            ("gla_forward", "float32"): 1e-5, ("gla_forward", "bfloat16"): 2 ** -8}
# card against CPU at full width, f32: prefill logits, features and caches and
# every decode step's logits, as tests/test_torch_models.py holds the port to
# the reference
SERVE_CPU_REL = 1e-4
NEAR_TIE = 1e-4             # top-two logit gap, relative to max |logit|


# the kernels one gla_forward call launches, as the profiler names them, and
# past one block's shared memory
GLA_KERNELS = ("gla_chunk_state_kernel", "gla_carry_kernel", "gla_chunk_out_kernel")
WIDE_GLA_KERNELS = ("gla_wide_state_kernel", "gla_carry_kernel", "gla_wide_out_kernel")


def row_rel_err(got, want) -> float:
    """max over the rows of the last axis of max |got − want| / max |want|
    within the row."""
    import torch

    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    assert bool(torch.isfinite(got).all()), "non-finite kernel output"
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())


def flash_work(b, sq, sk, h, hd, causal, itemsize):
    """(operations, bytes): q·k and p·v over the pairs the mask keeps, 4·hd
    each; q, k, v read and out written once."""
    pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * sk)
    return 4 * hd * pairs, itemsize * b * h * hd * (2 * sq + 2 * sk)


def gla_work(b, s, h, dk, dv, itemsize, chunk=128):
    """(operations, bytes) of the chunked form: per chunk of c tokens, the
    c(c+1)/2 kept pairs of q·k and of the gated scores·v, and the c·dk·dv
    products of the inter-chunk term and of the state update; q, k, v and
    log a read once, y and the state written once."""
    c = min(chunk, s)
    sizes = [c] * (s // c) + ([s % c] if s % c else [])
    flops = b * h * sum(n * (n + 1) * (dk + dv) + 4 * n * dk * dv for n in sizes)
    nbytes = b * s * h * (itemsize * (2 * dk + 2 * dv) + 4) + 4 * b * h * dk * dv
    return flops, nbytes


def attention_kernel_rows():
    """(a) flash_attention and gla_forward against their plain versions on
    the card at the serving shapes, the 2048-token prompt's included;
    returns the kernel list's rows, at the
    serving loop's prompt (B = 4, S = 512, bf16)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import (
        flash_attention, flash_attention_plain, gla_forward, gla_forward_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}

    def measure(name, label, dtype, fn, plain, library, kernels, work, main):
        got, want = fn(), plain()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        abs_err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        rels = [row_rel_err(g, w) for g, w in zip(got, want)]
        tol = ATTN_TOL[(name, str(dtype).split(".")[-1])]
        rate = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
        b = bound(*work, rate)
        r = dict(abs=abs_err, ms=cuda_ms(fn, 20), plain_ms=cuda_ms(plain, 3),
                 library_ms=cuda_ms(library, 20) if library is not None else None,
                 bound_ms=b[0], bound_by=b[1])
        alone = device_ms(fn, 10, kernels)
        log(f"  {name} {label}: max rel in a row {', '.join(f'{x:.2e}' for x in rels)}"
            f" (tol {tol:.1e})"
            f"  ms={r['ms']:.4f} (kernel alone {ms_text(alone)}) plain_ms={r['plain_ms']:.4f}"
            + " library_ms=" + (f"{r['library_ms']:.4f} ({library_device(library, 10)})"
                                if library is not None else "None")
            + f"  bound_ms={b[0]:.4f} ({b[1]}: {work[0] / 1e9:.2f} GFLOP, {work[1] / 1e6:.1f} MB)")
        assert all(x <= tol for x in rels), f"{name} {label}: kernel != plain"
        if main:
            rows[name] = r

    for b, s, h, hd, causal in ((4, 512, 25, 64, True), (4, 1024, 25, 64, True),
                                (4, SERVE_LONG, 25, 64, True), (4, 1000, 25, 64, False),
                                (1, 512, 25, 256, True)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            measure("flash_attention",
                    f"B={b} S={s} H={h} hd={hd} {'causal' if causal else 'full'} {dtype}", dtype,
                    lambda: flash_attention(q, k, v, causal=causal),
                    lambda: flash_attention_plain(q, k, v, causal=causal),
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
                    ("flash_fwd_kernel",), flash_work(b, s, s, h, hd, causal, q.element_size()),
                    main=(s, dtype, causal, hd) == (512, torch.bfloat16, True, 64))
    for b, s, h, dk, dv in ((4, 512, 25, 16, 64), (4, 1000, 25, 16, 64),
                            (4, SERVE_LONG, 25, 16, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k = (torch.randn((b, s, h, dk), generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            v = torch.randn((b, s, h, dv), generator=gen, device="cuda").to(dtype)
            la = -F.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
            measure("gla_forward", f"B={b} S={s} H={h} dk={dk} dv={dv} {dtype}", dtype,
                    lambda: gla_forward(q, k, v, la), lambda: gla_forward_plain(q, k, v, la),
                    None, GLA_KERNELS, gla_work(b, s, h, dk, dv, q.element_size()),
                    main=(s, dtype) == (512, torch.bfloat16))
    return rows


def serve_counted(cfg, params, what, prefills, flash_layers, **kw):
    """serve() with the launch counts set to 0 just before and read just
    after; each prefill must launch flash_attention once per layer that
    takes it and gla_forward once per layer."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve

    torch.cuda.synchronize()
    reset_launch_counts()
    out = serve(cfg, seed=SEED, device="cuda", params=params, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {"flash_attention": prefills * flash_layers, "gla_forward": prefills * cfg.n_layers}
    got = {k: counts[k] for k in want}
    log(f"  {what}: launches {got} over {prefills} prefills (expected {want})")
    assert got == want, f"{what}: launches {got}, expected {want}"
    b, n = kw["batch"], kw["new_tokens"]
    for i, r in enumerate(out):
        log(f"    round {i}: prefill {r.prefill_seconds * 1e3:.2f} ms, decode"
            f" {r.decode_seconds * 1e3 / n:.2f} ms a token ({b * n / r.decode_seconds:.1f} tok/s),"
            f" {b * n / r.seconds:.1f} tok/s over the round, drift score {r.score:.6f},"
            f" flagged {r.flagged}")
    return out, got


def serve_card_vs_cpu():
    """(c) full width in f32, depth cut to 2 layers (global layer 0 and one
    hymba_swa), card against CPU on the same weights and prompts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=2, param_dtype="float32")
    assert cfg.layer_pattern() == ("hymba", "hymba_swa")
    cpu = init_params(torch.Generator().manual_seed(SEED), cfg, device="cpu")

    def to_card(tree):
        return {k: to_card(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.cuda()

    card = to_card(cpu)
    b, s, n = SERVE_CPU_B, SERVE_CPU_S, SERVE_CPU_STEPS
    tokens = torch.from_numpy(np.random.default_rng(SEED + 3).integers(0, cfg.vocab, (b, s)))
    lg_c, c_c, f_c = prefill(cpu, cfg, tokens, cache_len=s + n)
    lg_g, c_g, f_g = prefill(card, cfg, tokens.cuda(), cache_len=s + n)
    pairs = [("logits", lg_g, lg_c), ("features", f_g, f_c)] + [
        (f"{kind}.{leaf}", c_g[kind][leaf], c_c[kind][leaf]) for kind in c_c for leaf in c_c[kind]]
    rels = {name: rel_err((g.cpu().float(),), (c.float(),))[1][0] for name, g, c in pairs}
    log("  (c) prefill card - CPU, max rel: " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()))
    assert all(v <= SERVE_CPU_REL for v in rels.values()), "prefill: card != CPU"
    tok, worst, ties = lg_c.argmax(-1), 0.0, []
    for i in range(n):
        lg_g, c_g = decode_step(card, cfg, tok.cuda(), c_g, s + i, max_seq=s + n)
        lg_c, c_c = decode_step(cpu, cfg, tok, c_c, s + i, max_seq=s + n)
        worst = max(worst, rel_err((lg_g.cpu(),), (lg_c,))[1][0])
        mine, want = lg_g.argmax(-1).cpu(), lg_c.argmax(-1)
        for row in torch.nonzero(mine != want).flatten().tolist():
            top = torch.topk(lg_c[row], 2).values
            ties.append((i, row, float((top[0] - top[1]) / lg_c[row].abs().max())))
        tok = want  # both continue the CPU's text
    log(f"  (c) {n} decode steps card - CPU: logits max rel {worst:.2e}; greedy tokens that"
        f" differ (step, row, top-two gap / max |logit|): {ties or 'none'}")
    assert worst <= SERVE_CPU_REL, "decode: card != CPU"
    assert all(gap <= NEAR_TIE for _, _, gap in ties), "a greedy token differs off a near-tie"


def serve_profile(cfg, params):
    """(d) torch.profiler over one full-width prefill (B = 4, S = 512) and 16
    decode steps: device time, busy share, top kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step, prefill

    b, s, n = SERVE["batch"], SERVE["prompt_len"], SERVE["new_tokens"]
    tokens = torch.as_tensor(np.random.default_rng(SEED + 4).integers(0, cfg.vocab, (b, s)),
                             device="cuda")
    for label, steps in (("prefill", 0), (f"prefill + {n} decode steps", n)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, caches, _ = prefill(params, cfg, tokens, cache_len=s + n)
            tok = logits.argmax(-1)
            for i in range(steps):
                logits, caches = decode_step(params, cfg, tok, caches, s + i, max_seq=s + n)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3
        assert dev_ms > 0, "the profiler saw no device time"
        log(f"  (d) {label}: wall {wall_ms:.2f} ms, device {dev_ms:.2f} ms,"
            f" busy share {dev_ms / wall_ms:.3f}")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def phase_serving():
    """Phase 9; returns the two attention kernels' rows and their launches
    over (b)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_count

    log("  (a) flash_attention and gla_forward against their plain versions")
    rows = attention_kernel_rows()
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED), cfg, device="cuda")
    torch.cuda.synchronize()
    log(f"  (b) {SERVE_ARCH} at full width: {cfg.n_layers} layers, d_model {cfg.d_model},"
        f" {cfg.n_heads} heads (kv {cfg.n_kv_heads}, hd {cfg.head_dim}), d_ff {cfg.d_ff},"
        f" vocab {cfg.vocab}, window {cfg.sliding_window}, global layers {cfg.global_layers},"
        f" {cfg.param_dtype}: {param_count(params) / 1e9:.3f} B parameters, drawn in"
        f" {time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    out, launches = serve_counted(cfg, params, f"serve {SERVE}", 5, cfg.n_layers, **SERVE)
    scores = [r.score for r in out]
    drift = SERVE["drift_round"]
    assert all(np.isfinite(scores)) and all(r.tokens.shape == (SERVE["batch"],
               SERVE["new_tokens"] + 1) for r in out)
    assert scores[drift] > max(x for i, x in enumerate(scores) if i != drift), (
        f"the drift round's score {scores[drift]} is not above the other rounds' {scores}")
    log(f"    peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    long = dict(SERVE, rounds=1, prompt_len=SERVE_LONG, drift_round=1)
    torch.cuda.reset_peak_memory_stats()
    _, more = serve_counted(cfg, params, f"serve at S={SERVE_LONG} (local attention in the"
                            f" {cfg.n_layers - len(cfg.global_layers)} hymba_swa layers)",
                            3, len(cfg.global_layers), **long)
    log(f"    peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches = {k: launches[k] + more[k] for k in launches}
    serve_card_vs_cpu()
    serve_profile(cfg, params)
    return rows, launches


# ------------------------------------------------ phase 10: a wide hidden layer

D_WIDE = 16                # devices of the wide phase
N_WIDE, N_WIDEST = 256, 320  # Ñ end to end; the widest the cluster solve and P chain take
# past the cluster paths: the runtime at Ñ = 384 on D_WIDER devices (the
# CPU's plain solves at Ñ = 384 and m = 561 take seconds a merge), and the
# kernels at Ñ = 768, the mnist_like width's widest bottleneck (n = m = 784,
# Ñ < n), and at 1024
D_WIDER, N_WIDER = 8, 384
N_MNIST = 784
WIDE_TICKS = range(3, 9)   # six ticks of make_streams', the shift (flagged) at the last
# the kernels each route launches (each one at least once)
WIDE_ROUTES = {
    ("f32", "star"): ("fleet_ingest", "masked_segment_sum_mix", "from_uv_solve"),
    ("f32", "ring"): ("fleet_ingest", "banded_merge_solve"),
    ("int8", "star"): ("fleet_ingest", "quantize_pack", "from_uv_solve"),
    ("stale", "ring"): ("fleet_ingest", "banded_mix", "from_uv_solve"),
}


def wide_runtimes(d: int, nh: int):
    """FleetRuntime at D = d, Ñ = nh on f32 star, f32 ring, int8 star and
    the stale ring (lags up to 3), merges every 3 ticks, card against CPU:
    flags and decisions equal, losses within phase 4's bounds, and each
    route's kernels launched."""
    import numpy as np
    import torch

    from repro_torch.fleet import init_fleet
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import FleetRuntime

    x_init, ticks_np, _ = make_streams(np.random.default_rng(SEED + 1), d, 2 * nh)
    fleet = init_fleet(torch.Generator().manual_seed(SEED), d, N_FEAT, nh, x_init,
                       activation="identity", ridge=RIDGE, device="cuda")
    fleet_cpu = fleet.replace(params=type(fleet.params)(*(x.cpu() for x in fleet.params)),
                              beta=fleet.beta.cpu(), p=fleet.p.cpu())
    sched = async_schedule(d)
    for (kind, name), kernels in WIDE_ROUTES.items():
        extra = dict(staleness=sched) if kind == "stale" else {}
        cfg = runtime_config(topologies(d)[name], "int8" if kind == "int8" else "f32",
                             merge_every=3, **extra)
        card = FleetRuntime(fleet, cfg, device="cuda")
        cpu = FleetRuntime(fleet_cpu, cfg, device="cpu")
        reset_launch_counts()
        worst, merges, flags, t0, card_s = 0.0, 0, 0, time.perf_counter(), 0.0
        for t in WIDE_TICKS:
            batch = np.ascontiguousarray(ticks_np[t])
            c0 = time.perf_counter()
            a = card.tick(batch)
            card_s += time.perf_counter() - c0
            b = cpu.tick(batch)
            rtol = INT8_LOSS_RTOL if kind == "int8" and merges else LOSS_RTOL
            np.testing.assert_allclose(a.losses, b.losses, rtol=rtol, atol=LOSS_ATOL)
            assert np.array_equal(a.drifted, b.drifted), f"wide {kind} {name} tick {t}: drifted"
            assert np.array_equal(a.fresh_detections, b.fresh_detections)
            da, db = a.decision, b.decision
            assert (da.merge, da.participants, da.round_bytes, da.fp_participants) == (
                db.merge, db.participants, db.round_bytes, db.fp_participants), (
                f"wide {kind} {name} tick {t}: decisions differ")
            worst = max(worst, float(np.max(np.abs(a.losses - b.losses) / np.abs(b.losses))))
            merges += da.merge
            flags += int(a.fresh_detections.sum())
        counts = launch_counts()
        log(f"  {kind} {name}: {len(WIDE_TICKS)} ticks at D={d}, Ñ={nh}, losses max rel"
            f" diff {worst:.3e}, flags {flags}, merges {merges}: equal; card"
            f" {card_s * 1e3 / len(WIDE_TICKS):.1f} ms a tick, both"
            f" {time.perf_counter() - t0:.1f} s; launches {({k: v for k, v in counts.items() if v})}")
        assert merges >= 2 and flags > 0, f"wide {kind} {name}: {merges} merges, {flags} flags"
        assert bool(torch.isfinite(card.states.p).all() and torch.isfinite(card.states.beta).all())
        for k in kernels:
            assert counts[k] > 0, f"wide {kind} {name}: {k} was never launched"


def wide_kernel_rows(n: int, m: int, windows: tuple[int, ...]):
    """At Ñ = n (D = 16, m right-hand sides): from_uv_solve (S = 1 and 16)
    and banded_merge_solve (hops 2) with no element differing from their
    plain versions, quantize_pack bit for bit, fleet_ingest (n = m features,
    T in ``windows``) within its 1e-4 bound; each with its time, alone and
    by events, and its bound, and from_uv_solve beside torch.linalg.solve."""
    import numpy as np
    import torch

    from repro_torch.fleet import init_fleet
    from repro_torch.kernels import (banded_merge_solve, banded_merge_solve_plain, fleet_ingest,
                                     fleet_ingest_plain, from_uv_solve, from_uv_solve_plain,
                                     quantize_pack, quantize_pack_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    solves = solve_kernels(n)

    def payloads(s):
        a = torch.randn((s, n, 3 * n), generator=gen, device="cuda")
        u = a @ a.transpose(1, 2) / (3 * n)
        return u, torch.randn((s, n, m), generator=gen, device="cuda")

    def timed(label, fn, kernels, flops, nbytes, reps, extra=""):
        ms, alone = cuda_ms(fn, reps), device_ms(fn, reps, kernels)
        b = bound(flops, nbytes)
        log(f"    {label}: ms={ms:.4f} (alone {ms_text(alone)}) bound_ms={b[0]:.4f} ({b[1]}){extra}")

    eye = torch.eye(n, device="cuda")
    for s in (1, D_WIDE):
        u, v = payloads(s)
        got, ref = from_uv_solve(u, v, ridge=RIDGE), from_uv_solve_plain(u, v, ridge=RIDGE)
        differ = sum(mismatches(g, r) for g, r in zip(got, ref))
        a1, rhs = u + RIDGE * eye, torch.cat([eye.expand(s, n, n), v], dim=2)
        lib = f", torch.linalg.solve ms={cuda_ms(lambda: torch.linalg.solve(a1, rhs), 10):.4f}" \
              f" ({library_device(lambda: torch.linalg.solve(a1, rhs), 10)})"
        log(f"  from_uv_solve S={s} Ñ={n} m={m}: {differ} of {s * n * (n + m)} elements differ")
        timed(f"from_uv_solve S={s}", lambda: from_uv_solve(u, v, ridge=RIDGE),
              solves, solve_flops(s, n, m), 4 * s * 2 * (n * n + n * m), 10, lib)
        assert differ == 0, f"from_uv_solve S={s} Ñ={n}: {differ} elements differ"
        del a1, rhs, got, ref
    u, v = payloads(D_WIDE)
    w = torch.cat([u, v], dim=2).contiguous()
    got, ref = banded_merge_solve(w, HOPS, ridge=RIDGE), banded_merge_solve_plain(w, HOPS, ridge=RIDGE)
    differ = sum(mismatches(g, r) for g, r in zip(got, ref))
    log(f"  banded_merge_solve D={D_WIDE} hops={HOPS} Ñ={n}: {differ} of {D_WIDE * n * (n + m)}"
        " elements differ")
    timed("banded_merge_solve", lambda: banded_merge_solve(w, HOPS, ridge=RIDGE),
          solves, D_WIDE * 2 * HOPS * n * (n + m) + solve_flops(D_WIDE, n, m),
          4 * D_WIDE * (n * (n + m) + n * n + n * m), 10)
    assert differ == 0, f"banded_merge_solve Ñ={n}: {differ} elements differ"
    del got, ref

    res = torch.randn((D_WIDE, n, n + m), generator=gen, device="cuda") * 0.01
    got, want = quantize_pack(u, v, res), quantize_pack_plain(u, v, res)
    mism = {k: mismatches(g, r) for k, g, r in zip(("codes", "scales", "residual"), got, want)}
    e = D_WIDE * n * (n + m)
    log(f"  quantize_pack D={D_WIDE} Ñ={n} (residual): mismatches {mism}")
    timed("quantize_pack", lambda: quantize_pack(u, v, res), ("quantize_pack_kernel",), 5 * e,
          4 * e * 2 + e + 4 * e + 4 * got[1].numel(), 50)
    assert not any(mism.values()), f"quantize_pack Ñ={n}: {mism}"
    del u, v, w, res, got, want

    if not windows:
        return
    # the autoencoder: m features in and out
    x_init, ticks_np, _ = make_streams(np.random.default_rng(SEED + 2), D_WIDE, 2 * n, m)
    fleet = init_fleet(torch.Generator().manual_seed(SEED), D_WIDE, m, n, x_init,
                       activation="identity", ridge=RIDGE, device="cuda")
    kernels = INGEST_KERNELS if n <= 320 else WIDE_INGEST_KERNELS
    for t in windows:
        window = torch.from_numpy(np.concatenate(list(ticks_np[: t // T]), axis=1)).cuda()
        got_s, got_l = fleet_ingest(fleet, window)
        ref_s, ref_l = fleet_ingest_plain(fleet, window)
        _, rels = rel_err((got_s.p, got_s.beta, got_l), (ref_s.p, ref_s.beta, ref_l))
        log(f"  fleet_ingest D={D_WIDE} T={t} Ñ={n}: max_rel P={rels[0]:.3e} beta={rels[1]:.3e}"
            f" loss={rels[2]:.3e} (tol {TOL['fleet_ingest']:.0e})")
        timed(f"fleet_ingest T={t}", lambda: fleet_ingest(fleet, window), kernels,
              *ingest_work(D_WIDE, t, m, n, m), 10)
        assert max(rels) <= TOL["fleet_ingest"], f"fleet_ingest T={t} Ñ={n}: {rels}"


def phase_wide():
    """Phase 10."""
    log(f"  (a) FleetRuntime at Ñ={N_WIDE} (D={D_WIDE}) and Ñ={N_WIDER} (D={D_WIDER}) on four"
        " routes, card against CPU")
    wide_runtimes(D_WIDE, N_WIDE)
    wide_runtimes(D_WIDER, N_WIDER)
    log(f"  (b) the kernels at Ñ={N_WIDEST} (m={N_FEAT}), 768 and 1024 (m={N_MNIST}) against"
        " their plain versions")
    wide_kernel_rows(N_WIDEST, N_FEAT, (T, 2 * T))
    wide_kernel_rows(768, N_MNIST, (T,))
    wide_kernel_rows(1024, N_MNIST, ())
    log("  (c) banded_mix past the widest ring a block holds, (d) robust_segment_sum_mix with"
        " chains past its registers, (e) flash_attention past 65 535 (batch, head) pairs")
    wide_band_trim_heads()
    log("  (f) gla_forward past one block's shared memory, (g) flash_attention at other head"
        " widths and on a misaligned view")
    wide_heads()


def wide_band_trim_heads():
    """banded_mix at hops 227 on 455 devices (2·hops + 1 = D) of a narrow
    payload, robust_segment_sum_mix at trim 5 and 8 on a har-width star,
    bit for bit; flash_attention at B·H = 65 600 (bf16, S = 16, hd 64)
    against its plain version row by row; each timed beside its bound."""
    import numpy as np
    import torch

    from repro_torch.fleet import payload_clip
    from repro_torch.kernels import (banded_mix, banded_mix_plain, flash_attention,
                                     flash_attention_plain, robust_segment_sum_mix,
                                     robust_segment_sum_mix_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    hops, d = 227, 455
    x = torch.randn((d, 16, 33), generator=gen, device="cuda")
    mism = mismatches(banded_mix(x, hops), banded_mix_plain(x, hops))
    e = x[0].numel()
    b = bound(2 * hops * d * e, 4 * 2 * d * e)
    log(f"  banded_mix D={d} hops={hops} ({e} floats a device): mismatches {mism}"
        f"  ms={cuda_ms(lambda: banded_mix(x, hops), 50):.4f} (alone"
        f" {ms_text(device_ms(lambda: banded_mix(x, hops), 20, ('banded_mix_wide_kernel',)))})"
        f" bound_ms={b[0]:.4f} ({b[1]})")
    assert mism == 0, f"banded_mix hops={hops}: {mism} elements differ"

    w = torch.randn((D, N_HID, N_HID + N_FEAT), generator=gen, device="cuda")
    _, scale = payload_clip(w, float(w.flatten(1).norm(dim=1).median()))
    mask = (torch.rand(D, generator=gen, device="cuda") < 0.9).to(torch.float32)
    cids = np.zeros(D, np.int32)
    e = w[0].numel()
    for trim in (5, 8):
        args = (w, cids, mask, scale, 1, trim)
        mism = {k: mismatches(g, r) for k, g, r in
                zip(("tot", "lo", "hi"), robust_segment_sum_mix(*args),
                    robust_segment_sum_mix_plain(*args))}
        b = bound((4 + 4 * trim) * D * e, 4 * (D * e + 2 * D + 2 + 3 * e))
        log(f"  robust_segment_sum_mix (star, D={D}, trim={trim}): mismatches {mism}"
            f"  ms={cuda_ms(lambda: robust_segment_sum_mix(*args), 20):.4f} (alone"
            f" {ms_text(device_ms(lambda: robust_segment_sum_mix(*args), 10, ('robust_segsum_kernel',)))})"
            f" bound_ms={b[0]:.4f} ({b[1]})")
        assert not any(mism.values()), f"robust_segment_sum_mix trim={trim}: {mism}"
    del w, scale

    bh, sq, hd = 65_600, 16, 64
    q, k, v = (torch.randn((bh, sq, 1, hd), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    rel = row_rel_err(flash_attention(q, k, v, causal=True),
                      flash_attention_plain(q, k, v, causal=True))
    flops, nbytes = flash_work(bh, sq, sq, 1, hd, True, 2)
    b = bound(flops, nbytes, H100_BF16_FLOPS)
    tol = ATTN_TOL[("flash_attention", "bfloat16")]
    log(f"  flash_attention B·H={bh} S={sq} hd={hd} bf16 causal: row max_rel {rel:.3e}"
        f" (tol {tol:.0e})  ms={cuda_ms(lambda: flash_attention(q, k, v, causal=True), 20):.4f}"
        f" bound_ms={b[0]:.4f} ({b[1]})")
    assert rel <= tol, f"flash_attention B·H={bh}: {rel:.3e}"


def wide_heads():
    """(f) gla_forward at dk × dv = 128 × 128 and 512 × 513 (B = 1,
    S = 2048, H = 4) on its tiled wide path, (g) flash_attention at head
    widths 80, 96 and 320 (B = 4, S = 512, H = 25, causal) and on a bf16
    view 2 bytes into its storage; bf16 and f32, each row by row against
    its plain version (ATTN_TOL), with its time by events and alone, its
    bound, and flash beside scaled_dot_product_attention on the same
    inputs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import (flash_attention, flash_attention_plain, gla_forward,
                                     gla_forward_plain)
    from repro_torch.kernels.gla_scan import wide_path

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def check(name, label, dtype, fn, plain, kernels, work, library=None):
        got, want = fn(), plain()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        rels = [row_rel_err(g, w) for g, w in zip(got, want)]
        tol = ATTN_TOL[(name, str(dtype).split(".")[-1])]
        b = bound(*work, H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS)
        lib = "" if library is None else (
            f" sdpa_ms={cuda_ms(library, 10):.4f} ({library_device(library, 5)})")
        log(f"  {name} {label}: max rel in a row {', '.join(f'{x:.2e}' for x in rels)}"
            f" (tol {tol:.1e})  ms={cuda_ms(fn, 10):.4f} (kernel alone"
            f" {ms_text(device_ms(fn, 5, kernels))}) plain_ms={cuda_ms(plain, 2):.4f}{lib}"
            f"  bound_ms={b[0]:.4f} ({b[1]}: {work[0] / 1e9:.2f} GFLOP, {work[1] / 1e6:.1f} MB)")
        assert all(x <= tol for x in rels), f"{name} {label}: kernel != plain"

    b, s, h = 1, SERVE_LONG, 4
    for dk, dv in ((128, 128), (512, 513)):
        assert wide_path(dk, dv), f"gla_forward {dk} x {dv} is not past a block's shared memory"
        for dtype in (torch.bfloat16, torch.float32):
            q, k = (torch.randn((b, s, h, dk), generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            v = torch.randn((b, s, h, dv), generator=gen, device="cuda").to(dtype)
            la = -F.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
            check("gla_forward", f"B={b} S={s} H={h} dk={dk} dv={dv} {dtype}", dtype,
                  lambda: gla_forward(q, k, v, la), lambda: gla_forward_plain(q, k, v, la),
                  WIDE_GLA_KERNELS, gla_work(b, s, h, dk, dv, q.element_size()))
            del q, k, v, la

    b, s, h = 4, 512, 25
    for hd in (80, 96, 320):
        kernel = ("flash_fwd_wide_kernel",) if hd > 256 else ("flash_fwd_kernel",)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            check("flash_attention", f"B={b} S={s} H={h} hd={hd} causal {dtype}", dtype,
                  lambda: flash_attention(q, k, v, causal=True),
                  lambda: flash_attention_plain(q, k, v, causal=True), kernel,
                  flash_work(b, s, s, h, hd, True, q.element_size()),
                  lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    hd = 64
    shape = (b, s, h, hd)

    def view():
        flat = torch.randn(b * s * h * hd + 1, generator=gen, device="cuda").to(torch.bfloat16)
        return flat[1:].view(shape)  # contiguous, 2 bytes into its storage

    q, k, v = view(), view(), view()
    assert q.data_ptr() % 16
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    check("flash_attention", f"B={b} S={s} H={h} hd={hd} causal bf16, a view off 16 bytes",
          torch.bfloat16, lambda: flash_attention(q, k, v, causal=True),
          lambda: flash_attention_plain(q, k, v, causal=True), ("flash_fwd_kernel",),
          flash_work(b, s, s, h, hd, True, 2),
          lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))


# ------------------------------------------- phase 11: telemetry, the §5 table

TELEMETRY_TURNS = (False, True, True, False) * 2  # telemetry off and on, in turns


def phase_telemetry(fleet, ticks_dev):
    """(a) FleetRuntime on the har-width star without and with telemetry,
    in turns: reports equal bit for bit, the sink held to the governor's
    ledger and the reports, tick p50/p99, the overhead, and the host time
    of the sink's bookkeeping (``_record_telemetry``) a tick; (b) the §5
    smoke grid in f32 and int8 on the card, its claims asserted."""
    import dataclasses

    import numpy as np

    from benchmarks.torch_paper_eval import run_bench, table_lines
    from repro_torch.obs import TelemetryConfig
    from repro_torch.runtime import runtime as runtime_module

    cfg = runtime_config(topologies(D)["star"])
    first, tick_ms, ingest_ms, runs = None, {False: [], True: []}, {False: [], True: []}, []
    record = runtime_module.FleetRuntime._record_telemetry
    booked = []

    def timed_record(self, *a, **k):
        t0 = time.perf_counter()
        record(self, *a, **k)
        booked.append(time.perf_counter() - t0)

    runtime_module.FleetRuntime._record_telemetry = timed_record
    try:
        for on in TELEMETRY_TURNS:
            rt, reports, ms, _, _ = drive(
                fleet, ticks_dev,
                dataclasses.replace(cfg, telemetry=TelemetryConfig()) if on else cfg)
            tick_ms[on] += ms
            ingest_ms[on] += [r.ingest_seconds * 1e3 for r in reports]
            runs.append(f"{'on' if on else 'off'} {np.median(ms):.3f}")
            if first is None:
                first = reports
            for a, b in zip(reports, first, strict=True):
                assert np.array_equal(a.losses, b.losses), f"tick {a.tick}: losses differ"
                assert np.array_equal(a.drifted, b.drifted) and np.array_equal(
                    a.fresh_detections, b.fresh_detections), f"tick {a.tick}: flags differ"
                assert dataclasses.asdict(a.decision) == dataclasses.asdict(b.decision), (
                    f"tick {a.tick}: decisions differ")
            if not on:
                assert rt.finalize_telemetry() is None
                continue
            summary = rt.finalize_telemetry()
            merges = sum(r.decision.merge for r in reports)
            fresh = sum(int(r.fresh_detections.sum()) for r in reports)
            assert summary["ticks"] == TICKS
            assert summary["bytes_total"] == rt.governor.state.bytes_spent == sum(
                r.decision.round_bytes for r in reports if r.decision.merge)
            assert summary["merge_rounds"] == rt.governor.state.merges == merges >= 2
            assert summary["detections_total"] == rt.detections_total == fresh
            lat = summary["tick_latency"]
            phases = ", ".join(f"{p} {s['p50_s'] * 1e3:.3f}" for p, s in summary["phases"].items())
            log(f"  star D={D}, {TICKS} ticks with telemetry: sink tick p50="
                f"{lat['p50_s'] * 1e3:.3f} p99={lat['p99_s'] * 1e3:.3f} ms; phase p50 ms:"
                f" {phases}; bytes {summary['bytes_total']}, merge rounds"
                f" {summary['merge_rounds']}, detections {summary['detections_total']}: equal to"
                " the governor's ledger and the reports")
    finally:
        runtime_module.FleetRuntime._record_telemetry = record
    off, on = np.median(tick_ms[False]), np.median(tick_ms[True])
    log(f"  tick p50 (host clock around tick(), {len(TELEMETRY_TURNS)} runs in turns:"
        f" {'; '.join(runs)}): off {off:.3f} ms, on {on:.3f} ms: overhead {on / off:.4f}x;"
        f" ingest p50 off {np.median(ingest_ms[False]):.3f} ms, on"
        f" {np.median(ingest_ms[True]):.3f} ms; the sink's bookkeeping a tick p50"
        f" {np.median(booked) * 1e3:.4f} ms, mean {np.mean(booked) * 1e3:.4f} ms"
        f" ({len(booked)} ticks); reports equal bit for bit in all runs")

    for precision in ("f32", "int8"):
        t0 = time.perf_counter()
        report = run_bench(smoke=True, payload_precision=precision, device="cuda")
        for line in table_lines(report):
            log(f"  {line}")
        claims = report["claims"]
        launches = {f"{n}/{t}": r["launches"] for n, row in report["scenarios"].items()
                    for t, r in row["topologies"].items()}
        log(f"  §5 smoke grid {precision} on {report['backend']} in"
            f" {time.perf_counter() - t0:.1f} s: all green {claims['all_green']}, AUC+comm"
            f" scenarios {claims['auc_and_comm_scenarios']}, kernels launched"
            f" {claims['kernels_launched']} {launches}")
        assert claims["all_green"], claims["green"]
        assert claims["auc_and_comm_scenarios"], f"{precision}: no scenario meets the claims"
        assert claims["kernels_launched"] is True, launches


# ---------------------------------------------- phase 12: durability

CHAOS_TICKS, CHAOS_EVERY, CHAOS_KILL = 64, 16, 40


def phase_durability(fleet, ticks_dev, ticks_np):
    """(a) The chaos sequence of benchmarks/torch_robust_fleet.py at the har
    width: the hardened star (phase 3's faults, robust trim 1) with
    telemetry, snapshots every 16 ticks, killed at tick 40, the newest
    snapshot cut to 128 bytes, a new runtime restored from the one before
    and replayed to tick 64: every report of the tail equal to an
    uninterrupted card run's bit for bit, the final state equal, the
    telemetry counters continuous and each kernel launched as often as in
    the uninterrupted tail; the snapshot's bytes, its save and restore
    seconds, and the tick times of snapshot windows beside the same ticks
    without one. (b) A D = 16 card snapshot restored on the CPU (f32 and
    hardened star) and ticked against the card at phase 4's bounds."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.fleet import RobustConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import TelemetryConfig
    from repro_torch.runtime import FleetRuntime

    base = runtime_config(topologies(D)["star"], robust=RobustConfig(trim=1),
                          faults=fault_injector(D), telemetry=TelemetryConfig())

    def timed_ticks(rt, t0, t1, counts=None):
        reports, ms = [], []
        for t in range(t0, t1):
            start = time.perf_counter()
            reports.append(rt.tick(ticks_dev[t % TICKS]))  # the stream's ticks, cycled
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - start) * 1e3)
            if counts is not None:
                counts.append(launch_counts())
        return reports, ms

    whole = FleetRuntime(fleet, base, device="cuda")
    whole.warmup(T)
    reset_launch_counts()
    counts_after = []
    want, whole_ms = timed_ticks(whole, 0, CHAOS_TICKS, counts_after)
    whole_summary = whole.finalize_telemetry()

    with tempfile.TemporaryDirectory() as tmp:
        snap = dataclasses.replace(base, snapshot_every=CHAOS_EVERY, snapshot_dir=tmp)
        doomed = FleetRuntime(fleet, snap, device="cuda")
        doomed.warmup(T)
        _, doomed_ms = timed_ticks(doomed, 0, CHAOS_KILL)
        save_s = doomed.telemetry.phase_stats()["snapshot"]
        del doomed  # the crash
        files = sorted(Path(tmp).glob("ckpt_*.npz"))
        nbytes = files[0].stat().st_size
        files[-1].write_bytes(files[-1].read_bytes()[:128])  # the torn newest snapshot

        # the revived runtime restores and replays without saving again
        revived = FleetRuntime(fleet, dataclasses.replace(snap, snapshot_every=None),
                               device="cuda")
        t0 = time.perf_counter()
        restored = revived.restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    assert restored == CHAOS_KILL // CHAOS_EVERY * CHAOS_EVERY - CHAOS_EVERY, restored
    assert int(revived.telemetry.ticks.value) == restored
    reset_launch_counts()
    got, _ = timed_ticks(revived, restored, CHAOS_TICKS)
    replay_launches = launch_counts()
    tail = {k: counts_after[-1][k] - counts_after[restored - 1][k] for k in replay_launches}
    for a, b in zip(got, want[restored:], strict=True):
        assert np.array_equal(a.losses, b.losses, equal_nan=True), f"tick {a.tick}: losses"
        assert np.array_equal(a.drifted, b.drifted) and np.array_equal(
            a.fresh_detections, b.fresh_detections), f"tick {a.tick}: flags"
        assert a.decision == b.decision, f"tick {a.tick}: decisions"
        assert a.nonfinite_payloads == b.nonfinite_payloads, f"tick {a.tick}: non-finite"
        assert (a.robust_scores is None) == (b.robust_scores is None)
        assert a.robust_scores is None or np.array_equal(a.robust_scores, b.robust_scores)
    assert torch.equal(revived.states.beta, whole.states.beta)
    assert torch.equal(revived.states.p, whole.states.p)
    assert replay_launches == tail, (replay_launches, tail)
    summary = revived.finalize_telemetry()
    for key in ("ticks", "merge_rounds", "bytes_total", "detections_total",
                "nonfinite_payloads_total"):
        assert summary[key] == whole_summary[key], (key, summary[key], whole_summary[key])
    rounds = sum(r.decision.merge for r in got)
    nonfinite = sum(r.nonfinite_payloads for r in got)
    assert rounds >= 2 and nonfinite > 0
    snap_ticks = [t for t in range(CHAOS_KILL) if (t + 1) % CHAOS_EVERY == 0]
    other = [t for t in range(CHAOS_KILL) if (t + 1) % CHAOS_EVERY]
    log(f"  chaos at D={D}, n={N_FEAT}, Ñ={N_HID} (hardened star, telemetry): snapshots every"
        f" {CHAOS_EVERY}, killed at {CHAOS_KILL}, newest torn, restored tick {restored}, replayed"
        f" to {CHAOS_TICKS}: {len(got)} reports equal bit for bit ({rounds} merges, {nonfinite}"
        f" non-finite payloads), final P and β equal, telemetry continuous, launches equal to the"
        f" uninterrupted tail {({k: v for k, v in tail.items() if v})}")
    log(f"  snapshot: {nbytes} bytes on disk (np.savez_compressed), save mean"
        f" {save_s['mean_s']:.3f} s, max {save_s['max_s']:.3f} s over {save_s['count']} saves"
        f" (the sink's snapshot phase), restore {restore_s:.3f} s")
    log(f"  host ms around tick(): snapshot ticks {snap_ticks}:"
        f" {[round(doomed_ms[t], 3) for t in snap_ticks]}, the same ticks without a snapshot"
        f" {[round(whole_ms[t], 3) for t in snap_ticks]}; the other ticks' p50 with snapshots"
        f" configured {np.median([doomed_ms[t] for t in other]):.3f}, without"
        f" {np.median([whole_ms[t] for t in other]):.3f}; a snapshot amortized over its window"
        f" {save_s['mean_s'] * 1e3 / CHAOS_EVERY:.3f} ms a tick")

    # (b) a card snapshot on the CPU at D_CPU
    small = fleet.replace(beta=fleet.beta[:D_CPU].contiguous(), p=fleet.p[:D_CPU].contiguous())
    for label, extra, after_rtol in (
            ("f32", {}, LOSS_RTOL),
            ("hardened", dict(robust=RobustConfig(trim=2), faults=fault_injector(D_CPU)),
             HARD_LOSS_RTOL)):
        with tempfile.TemporaryDirectory() as tmp:
            cfg = runtime_config(topologies(D_CPU)["star"], snapshot_dir=tmp, **extra)
            card = FleetRuntime(small, cfg, device="cuda")
            for t in range(TICKS // 2):
                card.tick(np.ascontiguousarray(ticks_np[t, :D_CPU]))
            card.snapshot()
            cpu = FleetRuntime(small, cfg, device="cpu")
            assert cpu.restore() == TICKS // 2
        assert torch.equal(cpu.states.beta, card.states.beta.cpu())
        worst, merges = 0.0, 0
        for t in range(TICKS // 2, TICKS):
            batch = np.ascontiguousarray(ticks_np[t, :D_CPU])
            a, b = card.tick(batch), cpu.tick(batch)
            np.testing.assert_allclose(a.losses, b.losses, rtol=after_rtol if merges else LOSS_RTOL,
                                       atol=LOSS_ATOL)
            assert np.array_equal(a.drifted, b.drifted) and a.decision == b.decision
            assert a.nonfinite_payloads == b.nonfinite_payloads
            assert np.array_equal(card.governor.robust_quarantined,
                                  cpu.governor.robust_quarantined)
            worst = max(worst, float(np.max(np.abs(a.losses - b.losses) / np.abs(b.losses))))
            merges += a.decision.merge
        assert merges >= 2
        log(f"  {label} star D={D_CPU}: card snapshot at tick {TICKS // 2} restored on the CPU"
            f" bit for bit, {TICKS // 2} more ticks beside the card: losses max rel diff"
            f" {worst:.3e}, flags, decisions and quarantines equal ({merges} merges)")


# ------------------------------------- phase 13: the paper's device-level API

PROTOCOL_DEVICES = ("walking", "sitting", "laying", "walking_upstairs")  # the last poisoned
# an activation the registry does not hold: the kernels project with the
# identity code and the wrappers apply it (a saturating one, such as
# softsign, leaves P too ill conditioned at this width for the unridged
# Eq. 15 inverse of the merge)
REGISTERED_ACTIVATION = "leaky_relu_smoke"
K1_STEPS = 64


def _leaky_relu(x):
    import torch

    return torch.where(x > 0, x, 0.1 * x)


def protocol_run(device, data):
    """Four EdgeDevices booted and trained at the har width (Ñ = 128) under
    a registered activation, the last one poisoned; a cooperative round with
    loss_threshold_selection; 64 k=1 steps of one merged device; train_elm
    on the pooled boot chunks. Returns what the two devices are held to."""
    import numpy as np
    import torch

    from repro_torch.core import ae_score, ae_train_step, init_slfn, predict_elm, train_elm
    from repro_torch.data import make_pattern_stream, roc_auc
    from repro_torch.federated import (
        EdgeDevice,
        FederationServer,
        cooperative_round,
        loss_threshold_selection,
    )

    train, test, x_eval, y_eval = data
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    devices = []
    for i, pattern in enumerate(PROTOCOL_DEVICES):
        xs = make_pattern_stream(train, pattern, seed=SEED + i)
        dev = EdgeDevice(f"edge-{i}", torch.Generator().manual_seed(SEED), train.n_features,
                         N_HID, xs[:2 * N_HID], activation=REGISTERED_ACTIVATION, ridge=RIDGE,
                         device=device)
        dev.train(xs[2 * N_HID:])
        devices.append(dev)
    rng = np.random.default_rng(SEED)
    devices[-1].train(rng.normal(size=(200, train.n_features)).astype(np.float32) * 40)
    sync()
    boot_s = time.perf_counter() - t0
    losses = {d.device_id: float(d.score(test.pattern(p)[:32]).mean())
              for d, p in zip(devices, PROTOCOL_DEVICES)}
    # a non-finite loss of the poisoned device is excluded all the same
    max_loss = 10.0 * float(np.nanmedian(list(losses.values())))
    select = loss_threshold_selection(losses, max_loss=max_loss)
    honest = devices[:-1]
    before = [roc_auc(d.score(x_eval), y_eval) for d in honest]
    server = FederationServer()
    t0 = time.perf_counter()
    cooperative_round(devices, server, select=select)
    sync()
    round_s = time.perf_counter() - t0
    chosen = list(select([d.device_id for d in devices]))
    after = [roc_auc(d.score(x_eval), y_eval) for d in honest]
    st = devices[0].state
    xs = torch.as_tensor(make_pattern_stream(test, "standing", seed=SEED)[:K1_STEPS],
                         device=st.device)
    for i in range(K1_STEPS):
        st = ae_train_step(st, xs[i])
    k1_loss = float(ae_score(st, xs).mean())
    pool = np.concatenate([make_pattern_stream(train, p, seed=SEED)[:N_HID]
                           for p in PROTOCOL_DEVICES[:3]])
    params = init_slfn(torch.Generator().manual_seed(SEED), train.n_features, N_HID,
                       device=device)
    t0 = time.perf_counter()
    model = train_elm(params, pool, pool, activation=REGISTERED_ACTIVATION, ridge=RIDGE)
    sync()
    elm_s = time.perf_counter() - t0
    pooled = torch.as_tensor(pool, device=model.beta.device)
    elm_loss = float(((predict_elm(model, pooled) - pooled) ** 2).mean())
    return dict(losses=losses, chosen=chosen, before=before, after=after, log=server.log,
                boot_s=boot_s, round_s=round_s, elm_s=elm_s, k1_loss=k1_loss,
                elm_loss=elm_loss)


def phase_protocol():
    """The paper's client/server protocol of §4.2 at the har width, on the
    card and the same run on the CPU: selection, comm log and bytes equal,
    the payload Ñ(Ñ+m)·4 bytes an upload, AUCs and losses within bounds,
    and every kernel the path routes to launched (hidden_proj and
    matmul_atb at the boots and train_elm, fleet_ingest training under the
    registered activation, rank1_add in the k=1 steps)."""
    import numpy as np

    from benchmarks.torch_common import normalized_dataset
    from repro_torch.core import register_activation
    from repro_torch.core.activations import kernel_code
    from repro_torch.data import anomaly_eval_arrays, train_test_split
    from repro_torch.kernels import launch_counts, reset_launch_counts

    register_activation(REGISTERED_ACTIVATION, _leaky_relu)
    assert kernel_code(REGISTERED_ACTIVATION) is None
    train, test = train_test_split(normalized_dataset("har", seed=SEED, samples_per_class=500),
                                   0.8, seed=SEED)
    patterns = [test.class_names.index(p) for p in PROTOCOL_DEVICES[:3]]
    x_eval, y_eval = anomaly_eval_arrays(test, patterns, seed=SEED)
    data = (train, test, x_eval, y_eval)
    reset_launch_counts()
    card = protocol_run("cuda", data)
    counts = launch_counts()
    cpu = protocol_run("cpu", data)
    n_dev = len(PROTOCOL_DEVICES)
    expected = {"hidden_proj": n_dev + K1_STEPS + 1, "matmul_atb": 2 * n_dev + K1_STEPS + 2,
                "rank1_add": K1_STEPS, "fleet_ingest": n_dev + 1}
    got = {k: counts[k] for k in expected}
    log(f"  launches on the card: {got} (expected {expected})")
    assert got == expected, (got, expected)
    payload = N_HID * (N_HID + N_FEAT) * 4
    log(f"  card: boot+train of {n_dev} devices {card['boot_s']:.3f} s, cooperative round"
        f" {card['round_s'] * 1e3:.3f} ms, train_elm {card['elm_s'] * 1e3:.3f} ms (host clock);"
        f" CPU: {cpu['boot_s']:.3f} s, {cpu['round_s'] * 1e3:.3f} ms, {cpu['elm_s'] * 1e3:.3f} ms")
    log(f"  validation losses card {card['losses']} CPU {cpu['losses']}; chosen {card['chosen']}")
    rounded = {k: [np.round(r[k], 4).tolist() for r in (card, cpu)] for k in ("before", "after")}
    log(f"  honest devices' AUC before/after the round, card {rounded['before'][0]} ->"
        f" {rounded['after'][0]}, CPU {rounded['before'][1]} -> {rounded['after'][1]}")
    log(f"  comm log: {card['log']} ({payload} bytes an upload: Ñ(Ñ+m)·4)")
    assert card["chosen"] == cpu["chosen"] == [f"edge-{i}" for i in range(n_dev - 1)]
    assert card["log"] == cpu["log"]
    assert card["log"].bytes_up == n_dev * payload and card["log"].uploads == n_dev
    assert card["log"].bytes_down == (n_dev - 1) * (n_dev - 2) * payload
    assert max(abs(a - b) for a, b in zip(card["after"], cpu["after"])) <= AUC_TOL["f32"]
    assert min(card["after"]) >= min(card["before"])
    # the merged model's k=1 steps and the batch ELM solve (Cholesky on the
    # card and on the CPU), at phase 7's bound for a merged model's losses
    for key in ("k1_loss", "elm_loss"):
        rel = abs(card[key] - cpu[key]) / abs(cpu[key])
        log(f"  {key}: card {card[key]:.6e} CPU {cpu[key]:.6e} (rel {rel:.2e}, tol 1e-2)")
        assert rel <= 1e-2, key


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
    for k, v in phase_hardened(fleet, ticks_dev, shifted).items():
        launches[k] = launches.get(k, 0) + v

    log("phase 4: card against CPU")
    phase_card_vs_cpu(fleet, ticks_np)

    log("phase 5: run_scenario on the paper's three workloads and on adversarial,"
        " card against CPU")
    phase_scenarios()

    log("phase 6: where a tick's time goes (torch.profiler)")
    phase_profile(fleet, ticks_dev)

    log("phase 7: the paper's device path (k=1 training, E²LM statistics, the"
        " cooperative update, Fig. 18, Table 4)")
    t0 = time.perf_counter()
    core_rows, core_launches = phase_device_path()
    rows.update(core_rows)
    launches.update(core_launches)
    log(f"  phase 7 took {time.perf_counter() - t0:.1f} s")

    log("phase 8: repeated synchronisation and stale merges (fleet_train_rounds,"
        " fleet_train_async, the stale FleetRuntime)")
    t0 = time.perf_counter()
    mix_rows, mix_launches = phase_repeated_sync(fleet, ticks_dev, ticks_np)
    rows.update(mix_rows)
    launches.update(mix_launches)
    log(f"  phase 8 took {time.perf_counter() - t0:.1f} s")

    log("phase 9: serving hymba-1.5b at full width (flash_attention, gla_forward, the"
        " serving loop, card against CPU, a profile)")
    t0 = time.perf_counter()
    attn_rows, attn_launches = phase_serving()
    rows.update(attn_rows)
    launches.update(attn_launches)
    log(f"  phase 9 took {time.perf_counter() - t0:.1f} s")

    log("phase 10: wide layers (Ñ = 256 and 384 end to end, the kernels at Ñ = 320, 768 and"
        " 1024) and the other sizes past the old limits (bands, trims, heads, GLA and flash"
        " widths)")
    t0 = time.perf_counter()
    phase_wide()
    log(f"  phase 10 took {time.perf_counter() - t0:.1f} s")

    log("phase 11: telemetry on the har-width star, the paper's §5 table (torch_paper_eval)")
    t0 = time.perf_counter()
    phase_telemetry(fleet, ticks_dev)
    log(f"  phase 11 took {time.perf_counter() - t0:.1f} s")

    log("phase 12: durability at the har width (the chaos sequence, snapshot size and times,"
        " a card snapshot on the CPU)")
    t0 = time.perf_counter()
    phase_durability(fleet, ticks_dev, ticks_np)
    log(f"  phase 12 took {time.perf_counter() - t0:.1f} s")

    log("phase 13: the paper's device-level API at the har width (EdgeDevice,"
        " cooperative_round, train_elm, a registered activation), card against CPU")
    t0 = time.perf_counter()
    phase_protocol()
    log(f"  phase 13 took {time.perf_counter() - t0:.1f} s")

    log(f"phase 14: kernels (phases 1-13 took {time.perf_counter() - start:.1f} s)")
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
        "robust_segment_sum_mix": ("src/repro_torch/csrc/robust_merge.cu",
                                   "src/repro/kernels/robust_merge.py:170"),
        "dense_mix": ("src/repro_torch/csrc/topology_merge.cu",
                      "src/repro/kernels/topology_merge.py:314"),
        "hidden_proj": ("src/repro_torch/csrc/hidden_proj.cu",
                        "src/repro/kernels/hidden_proj.py:66"),
        "matmul_atb": ("src/repro_torch/csrc/matmul_atb.cu",
                       "src/repro/kernels/matmul_atb.py:58"),
        "rank1_add": ("src/repro_torch/csrc/rank1_add.cu",
                      "src/repro/kernels/rank1_add.py:53"),
        "segment_sum_mix": ("src/repro_torch/csrc/topology_merge.cu",
                            "src/repro/kernels/topology_merge.py:172"),
        "segment_broadcast": ("src/repro_torch/csrc/topology_merge.cu",
                              "src/repro/kernels/topology_merge.py:269"),
        "banded_mix": ("src/repro_torch/csrc/topology_merge.cu",
                       "src/repro/kernels/topology_merge.py:106"),
        "flash_attention": ("src/repro_torch/csrc/flash_attn.cu",
                            "src/repro/kernels/flash_attn.py:105"),
        "gla_forward": ("src/repro_torch/csrc/gla_scan.cu",
                        "src/repro/kernels/gla_scan.py:106"),
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
    assert len(kernels) == len(sources) == 15, f"{len(kernels)} kernels in the list"
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
