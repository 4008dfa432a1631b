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
   (``torch.profiler``), no element differing from the plain version and
   a second call bit-identical, each β against an f64 solve beside
   ``torch.linalg.solve``'s distance (the star's within ``SOLVE_F64_RATIO``
   times it); ``banded_merge_solve``
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
   equal to the rounds routed to it; (e) (b) and (c) on star, isolated
   hierarchical, all_to_all and ring (one a route) and (d), card against
   CPU at D = 16;
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
    port's ``FleetRuntime`` at D = 8, Ñ = 384 (past the cluster solve and
    P chain), the har width otherwise, on f32 star, f32 ring,
    int8 star and the stale ring (lags up to 3), five ticks, the shifted
    device flagged at the last, one merge at the third, card against CPU
    (flags and decisions equal, losses within phase 4's bounds) and each
    route's kernels launched; (b) at Ñ = 320
    (m = 561), 768 and 1024 (m = 784, the mnist_like width),
    ``from_uv_solve`` (S = 1 and 16) and ``banded_merge_solve`` (hops 2)
    with no element differing from their plain versions, ``quantize_pack``
    bit for bit, ``fleet_ingest`` (T = 32 and 64 at 320, 32 at 768) within
    1e-4, each with its time alone and by events and its bound; (c)
    ``banded_mix`` at hops 227 on 455 devices and (d)
    ``robust_segment_sum_mix`` at trim 5 and 8 on the har-width star (its
    longest chains in registers), bit for bit; (e) ``flash_attention`` at
    B·H = 65 600 against its plain version; (f) ``gla_forward`` past one
    block's shared memory, at dk × dv = 128 × 128 and xLSTM's 512 × 513
    (B = 1, S = 2048, H = 4), bf16 and f32, on its tiled wide path; (g)
    ``flash_attention`` at head widths 80, 96 and 320 (B = 4, S = 512,
    H = 25) and on a bf16 view off a 16-byte boundary; each against its
    plain version, with its time alone, its bound and
    ``scaled_dot_product_attention``'s time;
11. telemetry and the paper's §5 table: (a) ``FleetRuntime`` on the
    har-width star (D = 256) without and with ``TelemetryConfig()``, in
    turns (off, on, on, off, twice): reports equal tick for tick, bit for bit;
    the sink's bytes, merge rounds and detections equal to the governor's
    ledger and the reports; tick p50/p99 from the sink and the overhead;
    (b) ``benchmarks/torch_paper_eval.py``'s smoke grid (driving, har,
    mnist_like on ring and star) in f32 and int8: its claims asserted,
    every routed kernel launched, one row per (scenario, topology);
12. durability at the har width: (a) the hardened star of the fleet's
    first 32 devices with telemetry (phase 3's faults) snapshotting every
    16 ticks, killed at tick 40, its
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
14. the port's benchmarks on the card: (a) ``benchmarks/torch_kernel_bench.py``,
    ``torch_merge_loss.py``, ``torch_ablation_hidden.py``,
    ``torch_rocauc_grid.py`` (quick), ``torch_fleet_scale.py`` (D = 64 and
    256, then ``--merge-bench`` at D = 256, 1024 and 4096) and
    ``torch_fleet_ingest.py`` (D = 256, 1024 and 4096), and
    ``torch_serve_runtime.py`` (D = 256, Ñ = 16, 220 ticks) and
    ``torch_serve_ingress.py`` (steady D = 256, Ñ = 8; the crash leg's
    child at D = 64), each main at its full grid with every claim asserted
    (sparse mixing and the fused ingest faster than their baselines at
    D ≥ 1024; ≥ 1k requests a second under the request p99 SLO) and every
    line passed on, each benchmark's routed kernels launched; (b) ``segment_sum_mix``
    (C = 1 and D/8) and ``banded_mix`` (hops 2) at D = 4096 on (32, 80)
    payloads and ``from_uv_solve`` at Ñ = 32, m = 48, S = 4096 with no
    element differing from their plain versions, ``fleet_ingest`` at
    D = 4096, Ñ = 32, n = m = 64, T = 32 within 1e-4, each with its time
    alone and its bound, ``masked_segment_sum_mix`` (C = 1) and
    ``segment_sum_mix`` (C = 1) at D = 4096 and 1024 beside their library
    calls, bounded by the larger of their bytes and their chain of adds,
    and ``robust_segment_sum_mix`` (C = 1) at D = 4096 at trims 1 and 5
    and at D = 1024 at trim 1, bit for bit; (c) ``fleet_scale``'s D = 8 rows
    card against CPU;
15. strided and mixed-type operands through ``hidden_proj``,
    ``segment_sum_mix`` and ``flash_attention``, each against its plain
    version on the same operands;
16. the async serving front-end (``repro_torch.serve``) at the har width:
    (a) ``ServeFrontend`` before a ``FleetRuntime`` at D = 256 (ring hops
    2, B = 2, merges every 16 ticks, telemetry on), warmed up on its tick
    worker; 16 pipelined clients submit 4 096 one-row requests, every one
    acked ``ok`` once, the front-end never failed, ``fleet_ingest``
    launched once a tick and ``banded_merge_solve`` once a merge, no
    kernel load after the warm-up; requests a second, request and tick
    p50/p99, the first live tick against the median, and the device's
    busy share over 16 one-window waves (``torch.profiler``); (b) the
    crash leg at D = 64: a child serves durable traffic (snapshots every 8
    ticks, a WAL) and SIGKILLs itself after tick 28, the parent recovers
    and replays bit for bit against the child's digests, telemetry
    continuous, fresh traffic ok; snapshot bytes, restore seconds,
    replayed windows; (c) a steady leg at D = 16 on the card with a WAL,
    the WAL replayed on the CPU runtime from the same initial fleet: flags,
    decisions and participants equal, losses within phase 4's bounds;
17. the cohort-paged arena (``repro_torch.fleet.arena``,
    ``repro_torch.runtime.cohort``): (a) at the har width, D = 2048 in
    pages of 512, ``CohortFleetRuntime`` on the card against the resident
    ``FleetRuntime`` on the card over 12 ticks (merges every 4, the shift
    from tick 8) on star, 50 isolated clusters (two straddle a page) and the
    ring (hops 2), and a leg serving two of the four cohorts a tick: flags,
    detections and decisions equal, losses within 1e-5 up to the first merge
    and after it within phase 4's bound or twice the resident runtime's own
    spread against itself on the reversed device axis; each runtime's
    launches (``fleet_ingest`` once a page a tick, the merge kernels once a
    page or round); a full-mask two-tier round against the solve of the
    flat sums taken in f64 within ``TWO_TIER_EXACT_TOL``, and against the
    flat merge within twice the card's own spread (the flat merge in
    reversed order, with its sums in f64, its f32 solve against f64);
    ``init_arena`` against ``init_fleet``; the
    tick, merge, devices a second and page in/out times by events; (b) D =
    64 in cohorts of 16 at Ñ = 4, card against CPU; (c) the page shapes of
    the cohort bench (``fleet_ingest`` on 16 384 devices at Ñ = 4, the
    masked sum on one cluster of 16 384, ``from_uv_solve`` at S = 1, Ñ = 4)
    against their plain versions and ``benchmarks/torch_fleet_cohort.py
    --full`` (D = 131 072 and 1 048 576, its claims and launches); each
    full round's f32 solve against an f64 solve of the same sums beside
    ``torch.linalg.solve``'s (the star's within ``SOLVE_F64_RATIO`` times
    it);
18. multi-process merges (``repro_torch.launch.mesh``,
    ``repro_torch.fleet.sharded``, ``repro_torch.federated.mesh_federation``):
    four ranks on card 0 over gloo through pinned host memory (``spawn``),
    at the har width, D = 256, 64 devices a rank: (a) ``fleet_train_sharded``
    over two windows equal to the single-process ``fleet_train`` bit for
    bit; (b) ``fleet_merge_sharded`` on star, hierarchical (32 clusters,
    with and without the head exchange) and all_to_all, one all-reduce of
    the partials, and (c) the open ring's halo at hops 2 and 64 (hops 65
    refused), each against the single-process merge at the larger of 1e-4
    and twice that merge's own spread on the reversed device axis, one
    model on every rank; the sharded merge's p50, its collective's ms and
    bytes beside the single-process merge's; (d) ``mesh_federated_train``,
    one device a rank, a merge after every window, against the
    single-process chain at twice its spread over the orders of the sum;
    (e) ``CohortMerger(mesh=)`` on an arena of 2048 in pages of 512, one
    page a rank, against ``mesh=None``, and ``cohort_tree_reduce`` over the
    mesh; each rank's launches (``fleet_ingest`` a window, ``segment_sum_mix``
    and ``from_uv_solve`` a psum merge, ``banded_merge_solve`` a halo merge);
    (f) a one-rank nccl mesh's star merge equal to the single-process merge
    bit for bit (skipped, and said so, only where torch has no nccl; a
    rank that fails fails the phase);
19. the rest of the model zoo (``xlstm-1.3b``, ``granite-moe-3b-a800m``,
    ``seamless-m4t-medium``, ``llama-3.2-vision-11b`` at their published
    widths and depths, ``arctic-480b`` at its widths and one layer): (d)
    ``flash_attention`` on the new shapes (cross attention from 512 queries
    and from one to 1024 frames and to 1601 patches, the encoder's
    bidirectional 1024, granite-moe's and arctic's causal prefills) and
    ``gla_forward`` at the mLSTM's dk 512, dv 513, bf16, against their
    plain versions, SDPA alone beside flash; (a) each model drawn on the
    card from a CUDA generator (parameters, seconds, memory), (b) served
    through ``serve`` with phase 9's settings (stub frontend embeddings
    drawn on the card), scores finite, tokens shaped, ``flash_attention``
    and ``gla_forward`` launched exactly as the layer pattern says, prefill
    ms, decode ms a token and peak memory beside a decode step's floor (its
    weights read once at 3.35 TB/s); (c) an xlstm-1.3b prefill at S = 1024,
    B = 1, with its sLSTM loop's share; (e) each config reduced (f32) card
    against CPU on the same weights, and a float8 KV cache on the card;
20. training: (a) ``flash_attention_bwd`` (the attention's backward, two
    launches, no atomics) against its plain version at gemma3-1b's global
    layer (B 8, S 128 and B 2, S 2048, H 4, hd 256, causal, bf16),
    granite-3-2b's (B 8, S 512, H 32, hd 64), hd 128 (B 4, S 512, H 32),
    the VLM's cross attention (512 → 1601, non-causal), one f32 case, Sq,
    Sk off the tiles and, past hd 256, the wide pair (B 2, S 512, H 4, hd
    320, causal, bf16; B 2, Sq 256, Sk 333, H 4, hd 512, full, f32), each
    with its route, CUDA-event, profiler, plain and SDPA-backward times and
    the bound, the forward with its row statistics bit for bit the forward
    without; and ``gla_backward`` (the GLA's backward, four
    launches, no atomics: bf16 on the tensor cores, f32 on the CUDA cores)
    against its plain version with a final-state cotangent at hymba-1.5b's
    training shape (B 4, S 512, H 25, dk 16, dv 64, bf16 and f32), xLSTM's
    mLSTM (B 2, S 256, H 4, 512 × 513, bf16) and S off the chunk (B 3, S
    200, H 5), the same bits twice, each shape's route (the kernels the
    profiler saw), CUDA-event, profiler and plain times and the bound (bf16
    at the tensor cores' rate); (b)
    ``repro_torch.launch.train`` at full width, one nccl rank: gemma3-1b
    (26 layers, d 1152, vocab 262 144, B 8, S 128, merges every 5 steps),
    then hymba-1.5b (32 layers, d 1600, vocab 32 001, B 4, S 512: four
    chunks, 10 steps, merges every 5) with the loss falling, step ms p50
    and max, peak memory, launches of ``flash_attention`` and
    ``flash_attention_bwd`` equal to the flash layers × steps × (2, 1) and of
    ``gla_forward`` and ``gla_backward`` to the GLA layers × steps × (2, 1),
    each then one step profiled for the device's busy share and the
    backwards' share of its kernels; then
    xlstm-1.3b (48 layers, d 2048, 42 mLSTM layers on GLA's wide path,
    B 2, S 256, 3 steps): the loss finite, the GLA launches exact, step ms
    and the sLSTM loops' share of a step; (c) reduced gemma3-1b,
    granite-moe-3b-a800m, hymba-1.5b and xlstm-1.3b (f32; the last two at S
    200, past a chunk) card against CPU: ``lm_loss`` and its gradients, two
    ``make_train_step`` steps with ``sgd`` and with ``make_optimizer``, one
    with two micro-batches; (d) ``gla_forward`` on CUDA inputs that require
    a gradient runs ``GLAForward``, one ``gla_backward`` launch, its
    gradients the CPU's; (e) the dry run on the host (``repro_torch.launch.
    dryrun_detector`` on the 16 × 16 layout and ``dryrun`` of gemma3-1b ×
    decode_32k, fake tensors, nothing on the card): the detector's
    collective bytes a device equal to its U/V payload, and each count equal
    to what the CPU-only test host counts (``DRYRUN_COUNTS``), with seconds;
21. the kernel list, one JSON object per kernel, then the result line.

Any failed check raises and the script exits non-zero. Without a CUDA
device, or without the rest of the repository beside it, it exits
non-zero and prints no result line. Weights and data are random, made
from ``SEED``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import re
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
# a merged star system's f32 Gauss-Jordan β against an f64 solve of the same
# sums, at most this many times torch.linalg.solve's (LU with partial
# pivoting) distance: 1.2-2.9x on the GPU tests' and phase 2's systems,
# 4.43x on phase 17's star of 2048 after 12 ticks, whose U is diagonal to
# 3e-7 of its pivots: there each β row takes 127 updates of a few ulps,
# each rounded once, where the library's substitution rounds fewer times.
# Dividing by the pivot in place of the reciprocal's product left that
# figure as it was; an update of the pivot row as the other rows was 8e5x
# there
SOLVE_F64_RATIO = 5
# phase 17: a full-mask two-tier round against the solve of the flat sums
# taken in f64, relative to max |β|. A sequential f32 sum of n nearly equal
# payloads drifts by about n·2^-24/4 of the sum: 3.1e-5 for the flat 2048,
# 7.7e-6 for a page of 512, whose four partials the tree then adds
TWO_TIER_EXACT_TOL = 1e-5
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
    calls (``benchmarks/torch_device_time.py``): the kernels alone, without the
    wrapper's host work, which bounds a short kernel's CUDA-event time. A
    call launches each kernel whose name holds one of ``kernels`` once
    (``matmul_atb``'s split product launches two), or as often as a dict of
    ``kernels`` says (the wide solve's panel kernels, once a panel), so the
    time is the sum over ``kernels`` of the mean time of a launch times its
    launches a call. Means, not totals over ``reps``: a session now and then
    drops some of the launches (seen on an H100: 3 of 4, 4 of 10) or all of
    them (a 2 µs kernel, in three sessions running), and is then asked
    again. None, printed as not measured, when five sessions missed a
    kernel: the time is a log line's, and no check reads it."""
    from benchmarks.torch_device_time import profile_sessions

    per_call = kernels if isinstance(kernels, dict) else dict.fromkeys(kernels, 1)
    try:
        ((by, _),) = profile_sessions(fn, calls=reps, needs=tuple(per_call))
    except RuntimeError:
        return None
    total = 0.0
    for kernel, times in per_call.items():
        hits = [(mean, n) for name, (mean, n) in by.items() if kernel in name]
        total += times * sum(mean * n for mean, n in hits) / sum(n for _, n in hits)
    return total / 1e3


def ms_text(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def call_device(fn, reps: int, what: str = "library alone") -> str:
    """Device time of one call of ``fn`` (every kernel it launches) and the
    name of its longest kernel, from one torch.profiler session of ``reps``
    calls (``benchmarks/torch_device_time.py``)."""
    from benchmarks.torch_device_time import per_call_us, profile_sessions

    try:
        ((by, _),) = profile_sessions(fn, calls=reps)
    except RuntimeError:
        return f"{what} not measured"
    us = per_call_us(by, reps)
    return f"{what} {sum(us.values()) / 1e3:.4f}: {max(us, key=us.get)[:72]}"


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
        assert differ == 0, f"from_uv_solve {shape}: {differ} elements differ from the plain version"
        # the pivot row kept out of its own step: β about as close to an
        # f64 solve of the same sums as the library's f32 solve
        b64 = torch.linalg.solve(a1.double(), v1.double())
        off = float((got[1].double() - b64).abs().max() / b64.abs().max())
        lib_off = float((lib[:, :, nh:].double() - b64).abs().max() / b64.abs().max())
        log(f"  from_uv_solve {shape}: beta off an f64 solve {off:.3e} of max|beta|,"
            f" torch.linalg.solve {lib_off:.3e}")
        if s == 1:
            assert off <= SOLVE_F64_RATIO * lib_off, f"from_uv_solve {shape}: {off:.3e} off f64"
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
        # and hi; per element read a scale multiply, a mask multiply and
        # add, the two sentinel selects and 2·trim min/max pairs
        nbytes = 4 * (d * e + 2 * d + n_cl + 1 + 3 * n_cl * e)
        flops = robust_ops(trim, d * e)
        r = runs[topo, trim] = dict(
            abs=max(float((g - x).abs().max()) for g, x in zip(got, want)), rels={},
            flops=flops, nbytes=nbytes, library_ms=None,
            ms=cuda_ms(lambda: robust_segment_sum_mix(*args), 50),
            plain_ms=cuda_ms(lambda: robust_segment_sum_mix_plain(*args), 2),
        )
        # every kernel the call launches: the plan is the wrapper's to pick
        alone = call_device(lambda: robust_segment_sum_mix(*args), 20, "kernels alone")
        b = bound(flops, nbytes)
        log(f"  robust_segment_sum_mix ({topo}, C={n_cl}, trim={trim}): mismatches {mism}"
            f"  ms={r['ms']:.4f} ({alone})"
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
# phase 8 (e)'s card-against-CPU chains: one topology a route (hierarchical
# with head exchange takes star's kernels in both chains)
CPU_ROUND_TOPOLOGIES = ("star", "hierarchical_isolated", "all_to_all", "ring")


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
        if name not in CPU_ROUND_TOPOLOGIES:
            continue
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


def measure_attention(name, label, dtype, fn, plain, library, kernels, work):
    """flash_attention or gla_forward against its plain version on the card,
    row by row at ``ATTN_TOL``, timed by CUDA events (the library call's
    beside), the kernels alone by the profiler; returns the kernel list's
    row."""
    import torch

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
    return r


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
        r = measure_attention(name, label, dtype, fn, plain, library, kernels, work)
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


def serve_counted(cfg, params, what, prefills, flash_layers, want=None, **kw):
    """serve() with the launch counts set to 0 just before and read just
    after; each prefill must launch flash_attention once per layer that
    takes it and gla_forward once per layer, or the counts ``want`` says."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve

    torch.cuda.synchronize()
    reset_launch_counts()
    out = serve(cfg, seed=SEED, device="cuda", params=params, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    if want is None:
        want = {"flash_attention": prefills * flash_layers,
                "gla_forward": prefills * cfg.n_layers}
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


def to_card(tree):
    return {k: to_card(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.cuda()


def serve_card_vs_cpu():
    """(c) full width in f32, depth cut to 2 layers (global layer 0 and one
    hymba_swa), card against CPU on the same weights and prompts."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=2, param_dtype="float32")
    assert cfg.layer_pattern() == ("hymba", "hymba_swa")
    cpu = init_params(torch.Generator().manual_seed(SEED), cfg, device="cpu")
    model_card_vs_cpu(cfg, cpu, "(c)")


def model_card_vs_cpu(cfg, cpu, label, frontend=None):
    """Prefill logits, features and every cache leaf, then SERVE_CPU_STEPS
    greedy decode steps (both continuing the CPU's text), card against CPU
    on the same weights, prompts and stub embeddings, at SERVE_CPU_REL; a
    greedy token may differ only off a near-tie."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, encoder_forward, prefill

    card = to_card(cpu)
    b, s, n = SERVE_CPU_B, SERVE_CPU_S, SERVE_CPU_STEPS
    tokens = torch.from_numpy(np.random.default_rng(SEED + 3).integers(0, cfg.vocab, (b, s)))
    fe_g = None if frontend is None else frontend.cuda()
    lg_c, c_c, f_c = prefill(cpu, cfg, tokens, frontend=frontend, cache_len=s + n)
    lg_g, c_g, f_g = prefill(card, cfg, tokens.cuda(), frontend=fe_g, cache_len=s + n)
    pairs = [("logits", lg_g, lg_c), ("features", f_g, f_c)] + [
        (f"{kind}.{leaf}", c_g[kind][leaf], c_c[kind][leaf]) for kind in c_c for leaf in c_c[kind]]
    rels = {name: rel_err((g.cpu().float(),), (c.float(),))[1][0] for name, g, c in pairs}
    log(f"  {label} prefill card - CPU, max rel: "
        + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()))
    assert all(v <= SERVE_CPU_REL for v in rels.values()), "prefill: card != CPU"
    enc_c = None if frontend is None else encoder_forward(cpu, cfg, frontend)
    enc_g = None if frontend is None else encoder_forward(card, cfg, fe_g)
    tok, worst, ties = lg_c.argmax(-1), 0.0, []
    for i in range(n):
        lg_g, c_g = decode_step(card, cfg, tok.cuda(), c_g, s + i, enc_out=enc_g, max_seq=s + n)
        lg_c, c_c = decode_step(cpu, cfg, tok, c_c, s + i, enc_out=enc_c, max_seq=s + n)
        worst = max(worst, rel_err((lg_g.cpu(),), (lg_c,))[1][0])
        mine, want = lg_g.argmax(-1).cpu(), lg_c.argmax(-1)
        for row in torch.nonzero(mine != want).flatten().tolist():
            top = torch.topk(lg_c[row], 2).values
            ties.append((i, row, float((top[0] - top[1]) / lg_c[row].abs().max())))
        tok = want  # both continue the CPU's text
    log(f"  {label} {n} decode steps card - CPU: logits max rel {worst:.2e}; greedy tokens that"
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

D_WIDE = 16                # devices of the wide kernels' rows
N_WIDEST = 320             # the widest the cluster solve and P chain take
# past the cluster paths: the runtime at Ñ = 384 on D_WIDER devices (the
# CPU's plain solves at Ñ = 384 and m = 561 take seconds a merge), and the
# kernels at Ñ = 768, the mnist_like width's widest bottleneck (n = m = 784,
# Ñ < n), and at 1024
D_WIDER, N_WIDER = 8, 384
N_MNIST = 784
# the runtime runs D_WIDER devices over five ticks of
# make_streams', the shift (flagged) at the last, with one merge at the third
# and two ticks after it: the CPU side's plain ingest and solves are most of
# the phase's time, so its depth is cut there (fleet size, ticks, merges)
WIDE_TICKS = range(4, 9)
WIDE_MERGE_EVERY = 3
WIDE_DETECTOR = dict(warmup=4, warmup_skip=1, rel_sigma=0.05)   # calibrated by the fifth tick
WIDE_REPS = 3              # timed calls of each wide kernel
# the kernels each route launches (each one at least once)
WIDE_ROUTES = {
    ("f32", "star"): ("fleet_ingest", "masked_segment_sum_mix", "from_uv_solve"),
    ("f32", "ring"): ("fleet_ingest", "banded_merge_solve"),
    ("int8", "star"): ("fleet_ingest", "quantize_pack", "from_uv_solve"),
    ("stale", "ring"): ("fleet_ingest", "banded_mix", "from_uv_solve"),
}


def wide_runtimes(d: int, nh: int):
    """FleetRuntime at D = d, Ñ = nh on f32 star, f32 ring, int8 star and
    the stale ring (lags up to 3), one merge (at the third tick), card
    against CPU: flags and decisions equal, losses within phase 4's bounds
    (two ticks after the merge), and each route's kernels launched."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.fleet import init_fleet
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import DetectorConfig, FleetRuntime

    x_init, ticks_np, _ = make_streams(np.random.default_rng(SEED + 1), d, 2 * nh)
    fleet = init_fleet(torch.Generator().manual_seed(SEED), d, N_FEAT, nh, x_init,
                       activation="identity", ridge=RIDGE, device="cuda")
    fleet_cpu = fleet.replace(params=type(fleet.params)(*(x.cpu() for x in fleet.params)),
                              beta=fleet.beta.cpu(), p=fleet.p.cpu())
    sched = async_schedule(d)
    for (kind, name), kernels in WIDE_ROUTES.items():
        extra = dict(staleness=sched) if kind == "stale" else {}
        cfg = dataclasses.replace(
            runtime_config(topologies(d)[name], "int8" if kind == "int8" else "f32",
                           merge_every=WIDE_MERGE_EVERY, **extra),
            detector=DetectorConfig(**WIDE_DETECTOR))
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
        assert merges >= 1 and flags > 0, f"wide {kind} {name}: {merges} merges, {flags} flags"
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
        lib_ms = cuda_ms(lambda: torch.linalg.solve(a1, rhs), WIDE_REPS)
        lib = f", torch.linalg.solve ms={lib_ms:.4f}" \
              f" ({library_device(lambda: torch.linalg.solve(a1, rhs), WIDE_REPS)})"
        log(f"  from_uv_solve S={s} Ñ={n} m={m}: {differ} of {s * n * (n + m)} elements differ")
        timed(f"from_uv_solve S={s}", lambda: from_uv_solve(u, v, ridge=RIDGE),
              solves, solve_flops(s, n, m), 4 * s * 2 * (n * n + n * m), WIDE_REPS, lib)
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
          4 * D_WIDE * (n * (n + m) + n * n + n * m), WIDE_REPS)
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
              *ingest_work(D_WIDE, t, m, n, m), WIDE_REPS)
        assert max(rels) <= TOL["fleet_ingest"], f"fleet_ingest T={t} Ñ={n}: {rels}"


def phase_wide():
    """Phase 10."""
    log(f"  (a) FleetRuntime at Ñ={N_WIDER} (D={D_WIDER}) on four routes, card against CPU")
    t0 = time.perf_counter()
    wide_runtimes(D_WIDER, N_WIDER)
    log(f"  (a) took {time.perf_counter() - t0:.1f} s")
    log(f"  (b) the kernels at Ñ={N_WIDEST} (m={N_FEAT}), 768 and 1024 (m={N_MNIST}) against"
        " their plain versions")
    wide_kernel_rows(N_WIDEST, N_FEAT, (T, 2 * T))
    wide_kernel_rows(768, N_MNIST, (T,))
    wide_kernel_rows(1024, N_MNIST, ())
    log("  (c) banded_mix past the widest ring a block holds, (d) robust_segment_sum_mix at"
        " trims 5 and 8, (e) flash_attention past 65 535 (batch, head) pairs")
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
        b = bound(robust_ops(trim, D * e), 4 * (D * e + 2 * D + 2 + 3 * e))
        log(f"  robust_segment_sum_mix (star, D={D}, trim={trim}): mismatches {mism}"
            f"  ms={cuda_ms(lambda: robust_segment_sum_mix(*args), 20):.4f}"
            f" ({call_device(lambda: robust_segment_sum_mix(*args), 10, 'kernels alone')})"
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
CHAOS_D = 32   # the chaos fleet: the first 32 devices (a snapshot of 29 MB at the har width)


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

    base = runtime_config(topologies(CHAOS_D)["star"], robust=RobustConfig(trim=1),
                          faults=fault_injector(CHAOS_D), telemetry=TelemetryConfig())
    whole_fleet, fleet = fleet, fleet.replace(beta=fleet.beta[:CHAOS_D].contiguous(),
                                              p=fleet.p[:CHAOS_D].contiguous())

    def timed_ticks(rt, t0, t1, counts=None):
        reports, ms = [], []
        for t in range(t0, t1):
            start = time.perf_counter()
            reports.append(rt.tick(ticks_dev[t % TICKS, :CHAOS_D]))  # the ticks, cycled
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
    log(f"  chaos at D={CHAOS_D}, n={N_FEAT}, Ñ={N_HID} (hardened star, telemetry): snapshots every"
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
    small = whole_fleet.replace(beta=whole_fleet.beta[:D_CPU].contiguous(),
                                p=whole_fleet.p[:D_CPU].contiguous())
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


# ------------------------------------- phase 14: the port's benchmarks

# the kernels each benchmark routes to (the device path's boots launch
# hidden_proj and matmul_atb, its streams fleet_ingest of one device; the
# cooperative update and the scores are library calls, as in the reference)
DEVICE_PATH_ROUTES = ("fleet_ingest", "hidden_proj", "matmul_atb")
BENCH_ROUTES = {
    "torch_kernel_bench": ("hidden_proj", "matmul_atb", "rank1_add"),
    "torch_merge_loss": DEVICE_PATH_ROUTES,
    "torch_ablation_hidden": DEVICE_PATH_ROUTES,
    "torch_rocauc_grid": DEVICE_PATH_ROUTES,
    "torch_fleet_scale": DEVICE_PATH_ROUTES + (
        "segment_sum_mix", "banded_merge_solve", "from_uv_solve"),
    "torch_fleet_scale --merge-bench": ("segment_sum_mix", "banded_mix", "from_uv_solve"),
    "torch_fleet_ingest": DEVICE_PATH_ROUTES,
    # the ring's soaks: one ingest a tick, one fused merge+solve a round,
    # and the int8 probe's quantize_pack a round
    "torch_serve_runtime": ("fleet_ingest", "banded_merge_solve", "quantize_pack"),
    "torch_serve_ingress": ("fleet_ingest", "banded_merge_solve"),
}
BENCH_D = 4096            # the merge and ingest benches' largest fleet
BENCH_NH, BENCH_M = 32, 48  # the merge bench's payloads: (32, 80)
INGEST_N = 64             # fleet_ingest.py's features (n = m) and window
INGEST_T = 32


# a cluster's sum is a chain of dependent adds in device order: D_cluster
# adds at the add's latency of 4 cycles, at the H100's 1.98 GHz boost clock
ADD_CYCLES, H100_CLOCK = 4, 1.98e9


def chain_ms(longest: int) -> float:
    return longest * ADD_CYCLES / H100_CLOCK * 1e3


def robust_ops(trim: int, device_elements: int) -> int:
    """robust_segment_sum_mix's operations: a device and element, the clip
    product, the masked product and add, the two sentinel selects and the
    chains' 4·trim min and max."""
    return (5 + 4 * trim) * device_elements


def bench_kernel_rows():
    """(b) the kernels at the benches' new shapes against their plain
    versions, each with its time by events, alone and its bound:
    segment_sum_mix (C = 1 at D = 4096 and 1024, D/8 at 4096) and
    masked_segment_sum_mix (C = 1 at D = 4096 and 1024) on (32, 80)
    payloads, each beside its library call alone and bounded by the larger
    of its bytes and its chain of adds; banded_mix (hops 2) at D = 4096 and
    from_uv_solve at Ñ = 32, m = 48, S = 4096, no element differing;
    fleet_ingest at D = 4096, Ñ = 32, n = m = 64, T = 32 within phase 2's
    bound; and robust_segment_sum_mix at D = 4096, C = 1, trim 1, bit for
    bit, timed against its bound (no library call computes it)."""
    import numpy as np
    import torch

    from benchmarks.torch_fleet_ingest import make_fleet
    from repro_torch.kernels import (
        banded_mix, banded_mix_plain, fleet_ingest, fleet_ingest_plain, from_uv_solve,
        from_uv_solve_plain, masked_segment_sum_mix, masked_segment_sum_mix_plain,
        robust_segment_sum_mix, robust_segment_sum_mix_plain, segment_sum_mix,
        segment_sum_mix_plain,
    )

    d, nh, m = BENCH_D, BENCH_NH, BENCH_M
    g = torch.Generator().manual_seed(SEED)
    w = torch.randn((d, nh, nh + m), generator=g).cuda()
    mask = (torch.rand(d, generator=g) < 0.9).float().cuda()
    e = nh * (nh + m)

    def row(label, fn, plain, kernels, flops, nbytes, exact=True, library=None, chain=0.0):
        got, want = fn(), plain()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        if exact:
            differ = sum(mismatches(a, b) for a, b in zip(got, want))
            err = f"{differ} elements differ"
            assert differ == 0, f"{label}: {err} from the plain version"
        else:
            rel = max(rel_err(got, want)[1])
            err = f"max_rel {rel:.3e} (tol {TOL['fleet_ingest']:.0e})"
            assert rel <= TOL["fleet_ingest"], f"{label}: {err}"
        ms = cuda_ms(fn, 20)
        # None: every kernel the call launches, named by the longest (the
        # segment sums' plan is the wrapper's to pick)
        alone = (call_device(fn, 10, "kernels alone") if kernels is None else
                 f"kernels alone {ms_text(device_ms(fn, 10, kernels))}, {kernels[0]}")
        b = bound(flops, nbytes)
        b = (chain, "chain") if chain > b[0] else b
        lib = "" if library is None else (f" {library[0]} {cuda_ms(library[1], 20):.4f},"
                                          f" {library_device(library[1], 10)};")
        log(f"  {label}: {err}; ms={ms:.4f} ({alone});"
            f"{lib} plain_ms={cuda_ms(plain, 2):.4f} bound_ms={b[0]:.4f} ({b[1]};"
            f" bytes {nbytes / H100_BYTES_PER_S * 1e3:.4f} for"
            f" {nbytes / 1e6:.1f} MB, chain {chain:.4f})")

    wf = w.view(d, e)
    for dd, n_cl in ((d, 1), (d // 4, 1), (d, d // 8)):
        ws, cids = w[:dd], (np.arange(dd) * n_cl // dd).astype(np.int32)
        longest = -(-dd // n_cl)
        nbytes = 4 * (dd * e + n_cl * e + n_cl + 1)
        lib = ("w.sum(0)", lambda ws=ws: ws.sum(0, keepdim=True)) if n_cl == 1 else None
        row(f"segment_sum_mix D={dd} C={n_cl}",
            lambda ws=ws, cids=cids, n_cl=n_cl: segment_sum_mix(ws, cids, n_cl),
            lambda ws=ws, cids=cids, n_cl=n_cl: segment_sum_mix_plain(ws, cids, n_cl),
            None, (dd - n_cl) * e, nbytes, library=lib,
            chain=chain_ms(longest))
        if n_cl == 1:
            ms_, wfs = mask[:dd], wf[:dd]
            row(f"masked_segment_sum_mix D={dd} C=1",
                lambda ws=ws, cids=cids, ms_=ms_: masked_segment_sum_mix(ws, cids, ms_, 1),
                lambda ws=ws, cids=cids, ms_=ms_: masked_segment_sum_mix_plain(ws, cids, ms_, 1),
                None, 2 * dd * e, nbytes + 4 * dd,
                library=("torch.mv by the mask", lambda wfs=wfs, ms_=ms_: torch.mv(wfs.t(), ms_)),
                chain=chain_ms(dd))
    zeros = np.zeros(d, np.int32)
    scale = (0.5 + 0.5 * torch.rand(d, generator=g)).cuda()
    # its loads, clip product, masked product and add, the sentinel selects
    # and two insertion chains a device and element; the bytes: the
    # payloads, mask and scale read once, the three sums written once
    for dd, trim in ((d, 1), (d // 4, 1), (d, 5)):
        robust = (w[:dd], zeros[:dd], mask[:dd], scale[:dd], 1, trim)
        row(f"robust_segment_sum_mix D={dd} C=1 trim={trim}",
            lambda robust=robust: robust_segment_sum_mix(*robust),
            lambda robust=robust: robust_segment_sum_mix_plain(*robust),
            None, robust_ops(trim, dd * e), 4 * (dd * e + 3 * e + 2 * dd + 2),
            chain=chain_ms(dd))
    row(f"banded_mix D={d} hops={HOPS}", lambda: banded_mix(w, HOPS),
        lambda: banded_mix_plain(w, HOPS), ("banded_mix_kernel",), 2 * HOPS * d * e,
        4 * 2 * d * e)
    h = torch.randn((d, 2 * nh, nh), generator=g).cuda()
    u = h.transpose(1, 2) @ h + 1e-2 * torch.eye(nh, device=w.device)
    v = w[:, :, nh:]
    row(f"from_uv_solve Ñ={nh} m={m} S={d}", lambda: from_uv_solve(u, v),
        lambda: from_uv_solve_plain(u, v), tuple(solve_kernels(nh)), solve_flops(d, nh, m),
        4 * d * (2 * nh * nh + 2 * nh * m))
    fleet, window = make_fleet(d, SEED, "cuda")
    flops, nbytes = ingest_work(d, INGEST_T, INGEST_N, nh, INGEST_N)
    row(f"fleet_ingest D={d} Ñ={nh} n=m={INGEST_N} T={INGEST_T}",
        lambda: (lambda s, l: (s.p, s.beta, l))(*fleet_ingest(fleet, window)),
        lambda: (lambda s, l: (s.p, s.beta, l))(*fleet_ingest_plain(fleet, window)),
        INGEST_KERNELS, flops, nbytes, exact=False)


def fleet_scale_card_vs_cpu():
    """(c) fleet_scale's D = 8 rows, card against CPU, from one fleet
    trained on the CPU and copied to the card: merged β within phase 4's
    bound, AUC rows within 1e-3, payloads and bytes equal."""
    from benchmarks.torch_fleet_scale import run, train_fleet

    trained = {}

    def on_cpu(fs, seed, device):
        trained["fleet"] = train_fleet(fs, seed, "cpu")
        return trained["fleet"]

    def on_card(fs, seed, device):
        f = trained["fleet"]
        return f.replace(params=type(f.params)(*(t.cuda() for t in f.params)),
                         beta=f.beta.cuda(), p=f.p.cuda())

    cpu = run((8,), device="cpu", train=on_cpu)
    card = run((8,), device="cuda", train=on_card)
    worst_beta = worst_auc = 0.0
    for a, b in zip(card, cpu, strict=True):
        assert (a["topology"], a["payloads"], a["bytes"]) == (b["topology"], b["payloads"],
                                                              b["bytes"])
        if "merged_beta" not in a:
            continue
        ref = b["merged_beta"]
        diff = float((a["merged_beta"].cpu() - ref).abs().max())
        rel = diff / float(ref.abs().max())
        auc = max(abs(a["auc_mean"] - b["auc_mean"]), abs(a["auc_min"] - b["auc_min"]))
        log(f"  fleet_scale/{a['topology']}/d8 card against CPU: merged beta max_rel {rel:.3e}"
            f" (tol {LOSS_RTOL:.0e}; max_abs {diff:.2e}),"
            f" AUC mean {a['auc_mean']:.4f} / {b['auc_mean']:.4f},"
            f" min {a['auc_min']:.4f} / {b['auc_min']:.4f}; payloads {a['payloads']},"
            f" bytes {a['bytes']} equal")
        assert rel <= LOSS_RTOL, (a["topology"], rel)
        assert auc <= AUC_TOL["f32"], (a["topology"], auc)
        worst_beta, worst_auc = max(worst_beta, rel), max(worst_auc, auc)
    log(f"  fleet_scale D=8 card against CPU: merged beta within {worst_beta:.3e},"
        f" AUCs within {worst_auc:.2e}")


def phase_benchmarks():
    """Phase 14: (a) the port benchmarks' mains on the card at their full
    grids (the serve soaks at their acceptance settings), every claim
    asserted and every line passed on, each benchmark's routed kernels
    launched (the counts set to 0 before each; the serve benches also hold
    every leg's launches to its ticks and rounds themselves);
    (b) the kernels at the benches' new shapes; (c) fleet_scale's D = 8
    rows card against CPU."""
    import torch

    from benchmarks import (
        torch_ablation_hidden, torch_fleet_ingest, torch_fleet_scale, torch_kernel_bench,
        torch_merge_loss, torch_rocauc_grid, torch_serve_ingress, torch_serve_runtime,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts

    merge_out = str(ROOT / "BENCH_torch_fleet_merge.json")
    history = str(ROOT / "BENCH_torch_history.jsonl")
    ingest_args = ["--out", str(ROOT / "BENCH_torch_fleet_ingest.json"), "--history", history]
    runs = {
        "torch_kernel_bench": lambda: torch_kernel_bench.main([]),
        "torch_merge_loss": lambda: torch_merge_loss.main([]),
        "torch_ablation_hidden": lambda: torch_ablation_hidden.main([]),
        "torch_rocauc_grid": lambda: torch_rocauc_grid.main([]),
        "torch_fleet_scale": lambda: torch_fleet_scale.main([]),
        "torch_fleet_scale --merge-bench": lambda: torch_fleet_scale.main(
            ["--merge-bench", "--merge-out", merge_out]),
        "torch_fleet_ingest": lambda: torch_fleet_ingest.main(ingest_args),
        "torch_serve_runtime": lambda: torch_serve_runtime.main(
            True, str(ROOT / "BENCH_torch_serve_runtime.json"), history),
        "torch_serve_ingress": lambda: torch_serve_ingress.main(
            True, str(ROOT / "BENCH_torch_serve_ingress.json"), history,
            crash_dir=str(ROOT / "BENCH_torch_crash_leg")),
    }
    assert runs.keys() == BENCH_ROUTES.keys()
    for name, fn in runs.items():
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        lines = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        for line in lines:
            log(f"  {line}")
        routed = {k: counts[k] for k in BENCH_ROUTES[name]}
        log(f"  {name}: {secs:.1f} s, launches {routed}")
        assert all(n > 0 for n in routed.values()), f"{name}: a routed kernel never ran: {routed}"
    merge = json.loads(Path(merge_out).read_text())["rows"]
    dense = [r for r in merge if r["dense_row_rel_err"] is not None]
    log("  merge bench: each device's dense row against its sparse sum, max_rel"
        f" {max(r['dense_row_rel_err'] for r in dense):.3e} (tol 1e-5) over {len(dense)} rows;"
        " dense/sparse at D >= 1024: " + ", ".join(
            f"{r['topology']} {r['mix_speedup']:.2f}x" for r in dense if r["n_devices"] >= 1024))
    bench_kernel_rows()
    fleet_scale_card_vs_cpu()


# ------------------------- phase 15: operands the reference takes, on the card


def phase_operands():
    """Phase 15: the kernels take what the reference and their plain versions
    take. hidden_proj (the k=1 step's row and the boot's 512 rows at the har
    width), segment_sum_mix (the har width's star and a D = 4096 star on
    (32, 80) payloads: both plans) and flash_attention (hymba-1.5b's
    prefill shape) each get a strided operand and a bf16 operand beside f32
    ones (computed in f32, as the reference promotes them), launch their
    kernel once a call, and equal the plain version on the same operands at
    the kernel's bound: hidden_proj at 1e-6 of the identity projection's
    largest value, the segment sums bit for bit, flash at 1e-5 of a row
    (f32, its plain version's dot products in PyTorch's orders; with k and
    v bf16 or f16, p rounded to v's type before p·v on both sides)."""
    import numpy as np
    import torch

    from repro_torch.kernels import (
        flash_attention, flash_attention_plain, hidden_proj, hidden_proj_plain, launch_counts,
        segment_sum_mix, segment_sum_mix_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def held(name, what, fn, plain, measure, tol):
        before = launch_counts()[name]
        got = fn()
        torch.cuda.synchronize()
        launched = launch_counts()[name] - before
        want = plain()
        assert got.dtype == want.dtype and got.shape == want.shape, (name, what)
        err = measure(got, want)
        log(f"  {name} {what}: {'mismatches' if tol == 0 else 'max_rel'} {err:.3e}"
            f" (tol {tol:.0e}), launches {launched}")
        assert launched == 1, f"{name} {what}: {launched} launches"
        assert err <= tol, f"{name} {what}: {err:.3e} against its plain version"

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def row_rel(got, want):
        got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
        return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())

    def count(got, want):
        return mismatches(got, want)

    alpha, bias = randn(N_FEAT, N_HID), randn(N_HID)
    for rows in (1, 512):
        xt = randn(N_FEAT, rows).t()  # (rows, 561), strided
        for what, args in ((f"{rows} rows, x strided", (xt, alpha, bias)),
                           (f"{rows} rows, alpha bf16", (xt.contiguous(), alpha.bfloat16(), bias))):
            held("hidden_proj", what, lambda a=args: hidden_proj(*a, activation="identity"),
                 lambda a=args: hidden_proj_plain(*a, activation="identity"), rel, 1e-6)
    for d, r, c in ((D, N_HID, N_HID + N_FEAT), (BENCH_D, BENCH_NH, BENCH_NH + BENCH_M)):
        packed = randn(d, r, c + 7)
        zeros = np.zeros(d, np.int32)
        for what, w in ((f"D={d} ({r}, {c}), a column slice", packed[:, :, :c]),
                        (f"D={d} ({r}, {c}), bf16", packed[:, :, :c].contiguous().bfloat16())):
            held("segment_sum_mix", what, lambda w=w: segment_sum_mix(w, zeros, 1),
                 lambda w=w: segment_sum_mix_plain(w, zeros, 1), count, 0)
    b, s, h, hd = 4, 512, 25, 64
    q, k, v = (randn(b, h, s, hd).transpose(1, 2) for _ in range(3))  # (B, S, H, hd) views
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    for what, args in (("q, k, v strided", (q, k, v)),
                       ("k bf16", (qc, kc.bfloat16(), vc)),
                       ("k, v bf16 (p rounded to bf16)", (qc, kc.bfloat16(), vc.bfloat16())),
                       ("k, v f16 (p rounded to f16)", (qc, kc.half(), vc.half()))):
        held("flash_attention", what, lambda a=args: flash_attention(*a),
             lambda a=args: flash_attention_plain(*a), row_rel, 1e-5)


# ------------------------------ phase 16: the async serving front-end

FRONTEND_B = 2                    # samples a device a window
FRONTEND_MERGE_EVERY = 16
FRONTEND_CLIENTS, FRONTEND_OUTSTANDING, FRONTEND_WAVES = 16, 32, 8   # 4 096 requests
FRONTEND_PROFILE_TICKS = 16
FRONTEND_CPU_MERGE_EVERY = 4      # (c): more rounds in a short leg
FRONTEND_CPU_WAVES = 24           # (c): one window a wave


def frontend_runtime(fleet, *, merge_every=FRONTEND_MERGE_EVERY, detector=None, device="cuda"):
    """The serving fleet: ring hops 2 at the fleet's width, telemetry on
    (the front-end's counters and its p99 signal live in the sink)."""
    from repro_torch.obs import TelemetryConfig
    from repro_torch.runtime import DetectorConfig, FleetRuntime, GovernorConfig, RuntimeConfig

    return FleetRuntime(fleet, RuntimeConfig(
        topology=topologies(fleet.beta.shape[0])["ring"], ridge=RIDGE,
        detector=detector or DetectorConfig(),
        governor=GovernorConfig(merge_every=merge_every),
        telemetry=TelemetryConfig(trace=False),
    ), device=device)


def frontend_requests(ticks_np, d: int, seed: int):
    """A factory of one-row requests: a uniform device, a row of its own
    stream (the har-width windows of phase 3)."""
    import numpy as np

    from repro_torch.serve import SampleRequest

    rng = np.random.default_rng(seed)

    def make(client: str):
        dev = int(rng.integers(d))
        row = ticks_np[int(rng.integers(ticks_np.shape[0])), dev, int(rng.integers(T))]
        return SampleRequest(device=dev, x=row, client=client)

    return make


def record_ticks(rt, reports, seconds):
    """Wrap ``rt.tick``: keep each report and its host seconds (the
    worker's own clock, from the call to the return of its losses)."""
    orig = rt.tick

    def tick(batch, **kw):
        t0 = time.perf_counter()
        rep = orig(batch, **kw)
        seconds.append(time.perf_counter() - t0)
        reports.append(rep)
        return rep

    rt.tick = tick


def frontend_steady(fleet, ticks_np):
    """(a) ServeFrontend at the har width (D = 256): 16 pipelined clients,
    4 096 one-row requests, then 16 one-window waves under torch.profiler."""
    import asyncio

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _lib, launch_counts, reset_launch_counts
    from repro_torch.serve import AdmissionConfig, SampleRequest, ServeConfig, ServeFrontend

    d = fleet.beta.shape[0]
    rt = frontend_runtime(fleet)
    reports, tick_s = [], []
    record_ticks(rt, reports, tick_s)
    fe = ServeFrontend(rt, ServeConfig(
        batch=FRONTEND_B, max_delay_s=0.004,
        admission=AdmissionConfig(max_queue_per_device=8, client_cap=128), seed=SEED))
    make = frontend_requests(ticks_np, d, SEED + 1)
    loads = _lib.library.cache_info().misses
    out = {}

    async def drive():
        await fe.start()
        out["loads_ready"] = _lib.library.cache_info().misses
        torch.cuda.synchronize()
        reset_launch_counts()

        async def client(c):
            acks = []
            for _ in range(FRONTEND_WAVES):
                acks += await asyncio.gather(*[fe.submit_with_retries(make(f"client-{c}"))
                                               for _ in range(FRONTEND_OUTSTANDING)])
            return acks

        t0 = time.perf_counter()
        nested = await asyncio.gather(*[client(c) for c in range(FRONTEND_CLIENTS)])
        out["wall"] = time.perf_counter() - t0
        out["acks"] = [a for acks in nested for a in acks]
        out["counts"] = launch_counts()
        out["ticks"], out["merges"] = rt.tick_no, rt.governor.state.merges
        tel = rt.telemetry
        out["tick_p50"], out["tick_p99"] = (tel.tick_seconds.quantile(0.5),
                                            tel.tick_seconds.quantile(0.99))
        out["ingress"] = tel.summary()["ingress"]
        # the busy share: one request a device a wave fills one window
        rng = np.random.default_rng(SEED + 2)
        waves = [[SampleRequest(device=dev, x=ticks_np[w % TICKS, dev, w % T],
                                client=f"p{dev % 4}")
                  for dev in range(d)] for w in range(FRONTEND_PROFILE_TICKS)]
        torch.cuda.synchronize()
        first = rt.tick_no
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for wave in waves:
                rng.shuffle(wave)
                out["acks"] += await asyncio.gather(*[fe.submit(r) for r in wave])
            torch.cuda.synchronize()
            out["prof_wall"] = time.perf_counter() - t1
        out["prof_ticks"] = rt.tick_no - first
        out["prof"] = prof
        await fe.stop()

    asyncio.run(drive())
    acks, counts = out["acks"], out["counts"]
    n_req = FRONTEND_CLIENTS * FRONTEND_OUTSTANDING * FRONTEND_WAVES
    statuses = {}
    for a in acks:
        statuses[a.status] = statuses.get(a.status, 0) + 1
    ing = rt.telemetry.summary()["ingress"]
    total = n_req + FRONTEND_PROFILE_TICKS * d
    assert fe.failed is None, f"the front-end stopped: {fe.failed}"
    assert statuses == {"ok": total}, statuses
    assert len({a.request_id for a in acks}) == total, "a request was acked twice"
    assert ing["accepted"] == ing["acked"] == total, ing
    assert fe.warmup_thread == "serve-tick-worker", fe.warmup_thread
    assert loads == out["loads_ready"] == _lib.library.cache_info().misses == 1, (
        "a kernel build or load after the warm-up")
    routed = {"fleet_ingest": counts["fleet_ingest"],
              "banded_merge_solve": counts["banded_merge_solve"]}
    assert routed == {"fleet_ingest": out["ticks"], "banded_merge_solve": out["merges"]}, (
        routed, out["ticks"], out["merges"])
    assert out["merges"] > 0, "no merge round in the steady leg"
    assert out["prof_ticks"] == FRONTEND_PROFILE_TICKS, out["prof_ticks"]
    steady = tick_s[:out["ticks"]]
    med = float(np.median(steady))
    lat = out["ingress"]["request_latency"]
    events = [e for e in out["prof"].key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    assert dev_ms > 0, "the profiler saw no device time"
    wall_ms = out["prof_wall"] * 1e3
    log(f"  steady: {n_req} requests by {FRONTEND_CLIENTS} clients in {out['wall']:.3f} s:"
        f" {n_req / out['wall']:.1f} requests/s; request p50 {lat['p50_s'] * 1e3:.3f} ms,"
        f" p99 {lat['p99_s'] * 1e3:.3f} ms; {out['ticks']} ticks"
        f" ({n_req / out['ticks']:.1f} requests a tick), tick p50"
        f" {out['tick_p50'] * 1e3:.3f} ms, p99 {out['tick_p99'] * 1e3:.3f} ms (the sink);"
        f" {out['merges']} merges; retried {out['ingress']['retried']},"
        f" deferred {out['ingress']['deferred']}")
    log(f"  first live tick {tick_s[0] * 1e3:.3f} ms on the worker against the median"
        f" {med * 1e3:.3f} ms ({tick_s[0] / med:.2f}x); warm-up on"
        f" {fe.warmup_thread}; library loads {loads} (none after the warm-up)")
    log(f"  launches {routed}: one ingest a tick, one fused merge+solve a round;"
        f" every ack ok, once ({total} with the profiled waves)")
    log(f"  profile: {FRONTEND_PROFILE_TICKS} one-window waves ({d} requests each), wall"
        f" {wall_ms:.2f} ms, device {dev_ms:.2f} ms, busy share {dev_ms / wall_ms:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return routed


def frontend_crash():
    """(b) the crash leg at the har width: a child serves durable traffic
    at D = 64 (snapshots every 8 ticks, a WAL) and SIGKILLs itself after
    tick 28; the parent recovers in process and replays bit for bit."""
    import tempfile

    import torch

    from benchmarks import torch_serve_ingress as si

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        c = si.run_crash(Path(tmp) / "crash", device=torch.device("cuda"),
                         n_features=N_FEAT, n_hidden=N_HID)
    log(f"  crash at D={c['n_devices']}, n=m={N_FEAT}, Ñ={N_HID}: the child served"
        f" {c['child_ticks']} ticks in {c['child_seconds']:.1f} s (its start, CUDA and the"
        f" warm-up included), SIGKILL; snapshot {c['snapshot_bytes']} bytes, restored"
        f" tick {c['restored_tick']} in {c['restore_seconds']:.3f} s, replayed"
        f" {c['replayed_windows']} windows ({c['replayed_compared']} digests bit for bit"
        f" against the child's; recover {c['recover_seconds']:.3f} s), launches"
        f" {c['replay_launches']}; telemetry ticks {c['telemetry_ticks_after_replay']};"
        f" {c['fresh_requests_ok']} fresh requests ok over"
        f" {c['post_recovery_ticks'] - c['telemetry_ticks_after_replay']} ticks"
        f" ({c['fresh_snapshots']} snapshotting, the longest tick"
        f" {c['fresh_tick_max_s']:.3f} s against the leg's"
        f" {si.CRASH_TICK_DEADLINE_S:.0f} s stall deadline), the ladder at NORMAL")
    return c["replay_launches"]


def frontend_card_vs_cpu(fleet, ticks_np):
    """(c) a steady leg at D = 16 on the card with a WAL; the same WAL
    replayed on the CPU runtime from the same initial fleet. Each wave is
    one full window (a two-row request a device, ``close_at_requests`` =
    D, no deadline and no stall threshold in reach): the comparison is of
    numbers, and no timing decides a window."""
    import asyncio
    import tempfile

    import numpy as np

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import DetectorConfig
    from repro_torch.serve import SampleRequest, ServeConfig, ServeFrontend, WriteAheadLog

    small = fleet.replace(beta=fleet.beta[:D_CPU].contiguous(), p=fleet.p[:D_CPU].contiguous())
    small_cpu = small.replace(params=type(small.params)(*(x.cpu() for x in small.params)),
                              beta=small.beta.cpu(), p=small.p.cpu())
    det = DetectorConfig(warmup=5, warmup_skip=1, rel_sigma=0.05)
    card = frontend_runtime(small, merge_every=FRONTEND_CPU_MERGE_EVERY, detector=det)
    cpu = frontend_runtime(small_cpu, merge_every=FRONTEND_CPU_MERGE_EVERY, detector=det,
                        device="cpu")
    card_reports, card_seconds = [], []
    record_ticks(card, card_reports, card_seconds)
    waves = [[SampleRequest(device=dev, client=f"c{dev}", x=ticks_np[
        w % TICKS, dev, FRONTEND_B * (w // TICKS):FRONTEND_B * (w // TICKS + 1)])
        for dev in range(D_CPU)] for w in range(FRONTEND_CPU_WAVES)]
    with tempfile.TemporaryDirectory() as wal_dir:
        fe = ServeFrontend(card, ServeConfig(
            batch=FRONTEND_B, close_at_requests=D_CPU, max_delay_s=600.0,
            tick_deadline_s=600.0, wal_dir=wal_dir, seed=SEED))

        async def drive():
            await fe.start()
            reset_launch_counts()
            acks = []
            for wave in waves:
                acks += await asyncio.gather(*[fe.submit(r) for r in wave])
            await fe.stop()
            return acks

        acks = asyncio.run(drive())
        counts = launch_counts()
        assert fe.failed is None and all(a.ok for a in acks), {a.status for a in acks}
        wal = WriteAheadLog(wal_dir)
        seqs = wal.replayable(0)
        assert len(seqs) == card.tick_no == len(card_reports) == FRONTEND_CPU_WAVES, (
            len(seqs), card.tick_no)
        worst, merges, flags = 0.0, 0, 0
        for seq, a in zip(seqs, card_reports, strict=True):
            batch, served, allow = wal.load(seq)
            b = cpu.tick(batch, served=served, allow_merge=allow)
            np.testing.assert_allclose(a.losses, b.losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
            assert np.array_equal(a.drifted, b.drifted), f"tick {seq}: drifted differs"
            assert np.array_equal(a.fresh_detections, b.fresh_detections)
            assert (a.decision.merge, a.decision.reason, a.decision.participants) == (
                b.decision.merge, b.decision.reason, b.decision.participants), seq
            worst = max(worst, float(np.max(np.abs(a.losses - b.losses) / np.abs(b.losses))))
            merges += a.decision.merge
            flags += int(a.fresh_detections.sum())
    assert merges >= 2, merges
    assert counts["fleet_ingest"] == card.tick_no and counts["banded_merge_solve"] == merges
    log(f"  card against CPU at D={D_CPU}: {len(acks)} requests, {card.tick_no} windows from"
        f" the WAL replayed on the CPU, losses max rel diff {worst:.3e} (rtol"
        f" {LOSS_RTOL:.0e}), flags {flags}, merges {merges}: flags, decisions and"
        f" participants equal")


def phase_serving_frontend(fleet, ticks_np):
    """Phase 16: the async serving front-end (repro_torch.serve) at the har
    width: (a) the steady leg, (b) the crash leg, (c) card against CPU."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"  on {smi}")
    t0 = time.perf_counter()
    launches = frontend_steady(fleet, ticks_np)
    log(f"  (a) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    frontend_crash()
    log(f"  (b) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    frontend_card_vs_cpu(fleet, ticks_np)
    log(f"  (c) took {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------- phase 17: the cohort-paged arena

COHORT_D, COHORT_C = 2048, 512    # (a): the har width, four pages of 512
# isolated clusters of 40-41 devices: with 48 every page boundary (a multiple
# of D/4) would fall between two clusters; with 50 the first and the third
# fall inside one, so two clusters take a partial from two pages
COHORT_CLUSTERS = 50
COHORT_TICKS = 12                 # merges at ticks 3, 7 and 11; the shift from SHIFT_TICK
COHORT_ACTIVE = 2                 # (a): a leg with two of the four cohorts a tick
COHORT_CPU_D, COHORT_CPU_C = 64, 16   # (b): the cohort bench's parity size and width
COHORT_CPU_NH, COHORT_CPU_N, COHORT_CPU_B = 4, 8, 4
# (a) the page shapes the paged path puts through the kernels at Ñ = 4 (the
# cohort bench's width): pages of 16 384 devices
PAGE_C, PAGE_NH, PAGE_N, PAGE_T = 16384, 4, 8, 4


def cohort_topologies(d: int, n_clusters: int):
    from repro_torch.fleet import hierarchical, ring, star

    return {"star": star(d),
            "hierarchical_isolated": hierarchical(d, n_clusters, head_exchange=False),
            "ring": ring(d, HOPS)}


def reversed_topology(topo):
    """The topology of the fleet with its device axis reversed: an isolated
    hierarchy's clusters relabelled so that their ids stay sorted."""
    import dataclasses

    import numpy as np

    if topo.kind != "segment" or topo.head_exchange:
        return topo
    cids = (topo.n_clusters - 1 - np.asarray(topo.cluster_ids)[::-1]).astype(np.int32)
    return dataclasses.replace(topo, cluster_ids=cids)


def cohort_batches(d: int, shifted_every: int = SHIFT_EVERY):
    """make_streams' har-like data at D = d, drawn on the card from SEED:
    (the boot chunks (d, 2Ñ, n), tick t's window (d, T, n))."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    bases = torch.randn((2, RANK, N_FEAT), generator=g, device="cuda") / RANK ** 0.5
    shifted = torch.arange(d, device="cuda") % shifted_every == 0

    def draw(pattern, rows, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        z = torch.randn((d, rows, RANK), generator=gen, device="cuda")
        x = torch.bmm(z, bases[pattern])
        return x + NOISE * torch.randn(x.shape, generator=gen, device="cuda")

    boot = draw(torch.zeros(d, dtype=torch.long, device="cuda"), 2 * N_HID, SEED + 1000)

    def tick(t):
        pattern = (shifted & (t >= SHIFT_TICK)).long()
        return draw(pattern, T, SEED + 2000 + t)

    return boot, tick


def fresh_arena(base):
    """A copy of ``base`` that shares no memory with it."""
    from repro_torch.fleet import FleetArena

    return FleetArena(alpha=base.alpha.clone(), bias=base.bias.clone(), p=base.p.clone(),
                      beta=base.beta.clone(), activation=base.activation, forget=base.forget)


def paged_ticks(base, cfg, tick, cohort, batch, *, active=None, device="cuda"):
    """A CohortFleetRuntime in cohorts of ``cohort`` over COHORT_TICKS ticks
    of ``tick(t)`` (host windows of ``batch`` samples, as a deployment hands
    them over) on a copy of ``base``, warmed up first, the launch counts set
    to 0 just before the first tick and read just after the last."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import CohortFleetRuntime

    rt = CohortFleetRuntime(fresh_arena(base), cfg, cohort_size=cohort, active_per_tick=active,
                            device=device)
    if device == "cuda":  # the leaves and the pages the copies read are pinned
        assert rt.arena.p.is_pinned() and rt.arena.beta[-cohort:].is_pinned()
    rt.warmup(batch)
    reports, tick_s, paging = [], [], []
    reset_launch_counts()
    for t in range(COHORT_TICKS):
        batch = tick(t)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports.append(rt.tick(batch))
        tick_s.append(time.perf_counter() - t0)
        paging.append(rt.last_paging)
    counts = launch_counts()
    return rt, reports, tick_s, paging, counts


def compare_reports(what, got, want, *, after=LOSS_RTOL, served_only=False):
    """Flags, fresh detections and decisions equal on every tick; losses
    within 1e-5 up to the first merge (its tick included) and ``after``
    from then on. Returns the largest relative loss difference."""
    import numpy as np

    merged, worst = False, 0.0
    for t, (a, b) in enumerate(zip(got, want, strict=True)):
        keep = a.served if served_only and a.served is not None else np.ones(len(a.losses), bool)
        rtol = after if merged else 1e-5
        np.testing.assert_allclose(a.losses[keep], b.losses[keep], rtol=rtol, atol=LOSS_ATOL,
                                   err_msg=f"{what} tick {t}")
        assert np.array_equal(a.drifted, b.drifted), f"{what} tick {t}: drifted"
        assert np.array_equal(a.fresh_detections, b.fresh_detections), f"{what} tick {t}"
        da, db = a.decision, b.decision
        assert (da.merge, da.reason, da.participants, da.round_bytes) == (
            db.merge, db.reason, db.participants, db.round_bytes), f"{what} tick {t}: {da} {db}"
        worst = max(worst, float(np.max(np.abs(a.losses[keep] - b.losses[keep])
                                        / np.abs(b.losses[keep]))))
        merged |= da.merge
    return worst


def order_spread(a_reports, b_reports) -> float:
    """The largest relative loss difference from the first tick after a
    merge on: the spread of one runtime against itself in another order of
    adds."""
    import numpy as np

    merged, worst = False, 0.0
    for a, b in zip(a_reports, b_reports, strict=True):
        if merged:
            worst = max(worst, float(np.max(np.abs(a.losses - b.losses) / np.abs(b.losses))))
        merged |= b.decision.merge
    return worst


def resident_ticks(fleet, cfg, tick, *, reverse=False):
    """The resident FleetRuntime on the card over COHORT_TICKS ticks; with
    ``reverse`` on the fleet with its device axis reversed (each window's
    rows and the topology with it), its reports put back in device order:
    the same merges summed in the other order."""
    import dataclasses

    import torch

    from repro_torch.runtime import FleetRuntime

    d = fleet.p.shape[0]
    perm = torch.arange(d - 1, -1, -1, device="cuda")
    if reverse:
        fleet = fleet.replace(p=fleet.p[perm].contiguous(), beta=fleet.beta[perm].contiguous())
        cfg = dataclasses.replace(cfg, topology=reversed_topology(cfg.topology))
    rt = FleetRuntime(fleet, cfg, device="cuda")
    rt.warmup(T)
    reports, secs = [], []
    back = perm.cpu().numpy()
    for t in range(COHORT_TICKS):
        batch = tick(t)
        if reverse:
            batch = batch[perm]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = rt.tick(batch)
        secs.append(time.perf_counter() - t0)
        if reverse:
            r = dataclasses.replace(r, losses=r.losses[back], drifted=r.drifted[back],
                                    fresh_detections=r.fresh_detections[back])
        reports.append(r)
    return reports, secs


def full_round_spread(rt, topo):
    """After the run: one full-mask two-tier round on a copy of the arena
    against the flat merge of the same fleet on the card, relative to max
    |β|, beside the card's own spreads at that state: the flat merge with
    the device axis reversed (another order of adds); the flat round with
    its sums taken in f64 (after a star merge the devices' payloads are
    nearly equal, and adding equal terms in any sequential order rounds
    alike, so the reversed order hides the sums' own error, which the
    two-tier tree's blocks do not share); and its Gauss-Jordan solve of its
    own sums against an f64 solve of them, with ``torch.linalg.solve``'s
    beside. The two-tier round itself is held against the solve of the
    flat sums taken in f64 (``exact``), where only its own sums' and its
    solve's rounding can show."""
    import numpy as np
    import torch

    from repro_torch.fleet import CohortMerger, fleet_merge_masked_kernel, fleet_to_uv
    from repro_torch.kernels import banded_mix, from_uv_solve, masked_segment_sum_mix

    d = rt.n_devices
    st = rt.arena.to_fleet(device="cuda")
    ones = torch.ones(d, device="cuda")
    flat = fleet_merge_masked_kernel(st, topo, ones, ridge=RIDGE)
    perm = torch.arange(d - 1, -1, -1, device="cuda")
    st_rev = st.replace(p=st.p[perm].contiguous(), beta=st.beta[perm].contiguous())
    rev = fleet_merge_masked_kernel(st_rev, reversed_topology(topo), ones, ridge=RIDGE)
    two = fresh_arena(rt.arena)
    CohortMerger(topo, rt.schedule, ridge=RIDGE, device="cuda").merge(two, np.ones(d, bool))
    scale = float(flat.beta.abs().max())
    gap = float((two.beta.cuda() - flat.beta).abs().max()) / scale
    order = float((rev.beta[perm] - flat.beta).abs().max()) / scale
    nh = st.p.shape[-1]

    # the flat round's distinct systems and their sums, in f32 and in f64
    uv = fleet_to_uv(st, ridge=RIDGE)
    w = torch.cat([uv.u, uv.v], dim=2)
    w64 = w.double()
    if topo.kind == "banded":
        sums = banded_mix(w, topo.hops)
        sums64 = sum(torch.roll(w64, -o, dims=0) for o in range(-topo.hops, topo.hops + 1))
    elif topo.head_exchange:
        sums = masked_segment_sum_mix(w, np.zeros(d, np.int32), ones, 1)
        sums64 = w64.sum(0, keepdim=True)
    else:
        sums = masked_segment_sum_mix(w, topo.cluster_ids, ones, topo.n_clusters)
        cids = torch.as_tensor(topo.cluster_ids, dtype=torch.long, device="cuda")
        sums64 = torch.zeros((topo.n_clusters,) + tuple(w.shape[1:]), dtype=torch.float64,
                             device="cuda").index_add_(0, cids, w64)
    del w64
    sums64 = sums64.float()
    _, beta32 = from_uv_solve(sums[:, :, :nh], sums[:, :, nh:], ridge=RIDGE)
    _, beta_sums64 = from_uv_solve(sums64[:, :, :nh], sums64[:, :, nh:], ridge=RIDGE)
    adds = float((beta_sums64 - beta32).abs().max()) / scale
    if topo.kind == "banded":
        per_device = beta_sums64
    elif topo.head_exchange:
        per_device = beta_sums64.expand(d, -1, -1)
    else:
        per_device = beta_sums64[cids]
    exact = float((two.beta.cuda() - per_device).abs().max()) / scale
    del per_device
    a = sums[:, :, :nh].double() + RIDGE * torch.eye(nh, dtype=torch.float64, device="cuda")
    beta64 = torch.linalg.solve(a, sums[:, :, nh:].double())
    solve = float((beta32.double() - beta64).abs().max()) / scale
    lib = torch.linalg.solve(a.float(), sums[:, :, nh:])
    lib_solve = float((lib.double() - beta64).abs().max()) / scale
    chol = torch.cholesky_solve(sums[:, :, nh:], torch.linalg.cholesky(a.float()))
    chol_solve = float((chol.double() - beta64).abs().max()) / scale
    diag = a.diagonal(dim1=1, dim2=2)
    off_diag = float((a - torch.diag_embed(diag)).abs().max() / diag.min())
    del st, st_rev, flat, rev, uv, w, sums, sums64, a, beta64, lib, chol
    return gap, exact, order, adds, solve, lib_solve, chol_solve, off_diag


def paging_text(paging, ticks_s):
    """The median tick's paging times (events on the card's copy and
    compute streams) and how much of the copies the overlap hid."""
    import numpy as np

    i = int(np.argsort(ticks_s)[len(ticks_s) // 2])
    p = paging[i]
    copies = p["in_s"] + p["out_s"]
    hidden = (copies + p["compute_s"] - p["span_s"]) / copies
    return (f"page in {p['in_s'] * 1e3:.2f} ms, out {p['out_s'] * 1e3:.2f} ms, ingest"
            f" {p['compute_s'] * 1e3:.2f} ms, span {p['span_s'] * 1e3:.2f} ms a tick: the overlap"
            f" hid {hidden:.2f} of the copies")


def cohort_full_width(smi):
    """(a) The har width: CohortFleetRuntime on the card against the
    resident FleetRuntime on the card, tick by tick, on star, isolated
    hierarchical (48 clusters, some straddling a page) and the ring (hops
    2), then a leg serving two of the four cohorts a tick."""
    import numpy as np
    import torch

    from repro_torch.fleet import CohortSchedule, cohort_round_cost, init_arena, init_fleet
    from repro_torch.runtime import FleetRuntime

    d, c = COHORT_D, COHORT_C
    boot, tick = cohort_batches(d)
    t0 = time.perf_counter()
    base = init_arena(torch.Generator().manual_seed(SEED), d, N_FEAT, N_HID,
                      lambda lo, hi: boot[lo:hi], cohort_size=c, activation="identity",
                      ridge=RIDGE, device="cuda")
    init_s = time.perf_counter() - t0
    fleet = init_fleet(torch.Generator().manual_seed(SEED), d, N_FEAT, N_HID,
                       boot.cpu().numpy(), activation="identity", ridge=RIDGE, device="cuda")
    del boot
    # the boot's κ(U₀ + εI) ~ 1e6 at this width: the pages' products sum in
    # other orders than the whole fleet's, so P and β are held by what they
    # predict, the first window's scores (its pre-train losses)
    p_rel = float((base.p.cuda() - fleet.p).abs().max() / fleet.p.abs().max())
    b_rel = float((base.beta.cuda() - fleet.beta).abs().max() / fleet.beta.abs().max())
    x = tick(0)

    def scores(beta):
        y = torch.bmm(x @ fleet.params.alpha + fleet.params.bias, beta)
        return ((x - y) ** 2).mean(dim=(1, 2))

    s_rel = float(((scores(base.beta.cuda()) - scores(fleet.beta)).abs()
                   / scores(fleet.beta).abs()).max())
    log(f"  init_arena D={d} in pages of {c} on the card ({init_s:.2f} s, {base.nbytes / 2**20:.0f}"
        f" MB of arena) against init_fleet: first-window scores max_rel {s_rel:.3e} (tol 1e-4);"
        f" P {p_rel:.3e}, beta {b_rel:.3e} of their largest")
    assert s_rel <= 1e-4, (s_rel, p_rel, b_rel)
    fleet = base.to_fleet(device="cuda")   # both runtimes start from one state
    host_tick = lambda t: tick(t).cpu().numpy()  # noqa: E731
    launches, spreads = {}, {}
    for name, topo in cohort_topologies(d, COHORT_CLUSTERS).items():
        if name == "hierarchical_isolated":
            cost = cohort_round_cost(topo, CohortSchedule(d, c), N_HID, N_FEAT)
            assert cost.tier2_payloads > 0, "no cluster straddles a page boundary"
        cfg = runtime_config(topo)
        rt, reports, tick_s, paging, counts = paged_ticks(base, cfg, host_tick, c, T)
        merges = sum(r.decision.merge for r in reports)
        route = rt.merger.launches_per_round()
        want = {"fleet_ingest": rt.schedule.n_cohorts * COHORT_TICKS}
        for k, v in route.items():
            want[k] = want.get(k, 0) + v * merges
        got = {k: v for k, v in counts.items() if v}
        assert got == want, f"paged {name}: launches {got}, expected {want}"
        rt.assert_compile_once()
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        res_reports, res_s = resident_ticks(fleet, cfg, tick)
        rev_reports, _ = resident_ticks(fleet, cfg, tick, reverse=True)
        spread = order_spread(rev_reports, res_reports)
        after = max(LOSS_RTOL, 2 * spread)
        worst = compare_reports(f"paged {name}", reports, res_reports, after=after)
        flags = sum(int(r.fresh_detections.sum()) for r in reports)
        assert merges >= 2 and flags > 0, (name, merges, flags)
        spreads[name] = spread
        text = paging_text(paging, tick_s)
        merge_ms = [r.merge_seconds * 1e3 for r in reports if r.merge_seconds is not None]
        tick_p50 = float(np.median(tick_s))
        log(f"  {name}: {COHORT_TICKS} ticks at D={d} in {rt.schedule.n_cohorts} pages, flags"
            f" {flags}, merges {merges}: flags, detections and decisions equal to the resident"
            f" runtime's, losses max rel diff {worst:.3e} (after the first merge rtol"
            f" {after:.3e}: phase 4's, or twice the resident runtime's own spread against itself"
            f" on the reversed device axis, {spread:.3e}); launches {got}")
        log(f"    paged tick p50 {tick_p50 * 1e3:.2f} ms ({d / tick_p50:.0f} devices/s), merge"
            f" p50 {np.median(merge_ms):.2f} ms; resident tick p50 {np.median(res_s) * 1e3:.2f}"
            f" ms; {text}; on {smi}")
        merge_ticks = [x for x in paging if "merge_in_s" in x]
        if merge_ticks:
            m = merge_ticks[-1]
            log(f"    a merge's pages: in {m['merge_in_s'] * 1e3:.2f} ms, out"
                f" {m['merge_out_s'] * 1e3:.2f} ms, compute {m['merge_compute_s'] * 1e3:.2f} ms"
                f" (events)")
        (gap, exact, order, adds, solve, lib_solve, chol_solve,
         off_diag) = full_round_spread(rt, topo)
        tol = max(1e-5, 2 * max(order, adds, solve))
        log(f"    a full-mask round after the run: two-tier against the solve of the flat sums"
            f" taken in f64 max|Δβ|/max|β| {exact:.3e} (bound {TWO_TIER_EXACT_TOL:.0e});"
            f" against the flat merge {gap:.3e} (bound {tol:.3e}); the card's own spreads:"
            f" reversed order {order:.3e}, the flat sums in f64 {adds:.3e}, f32 solve against"
            f" f64 {solve:.3e} (torch.linalg.solve {lib_solve:.3e}, {solve / lib_solve:.2f}x;"
            f" an f32 Cholesky solve {chol_solve:.3e}; the largest off-diagonal of U + εI"
            f" {off_diag:.3e} of its smallest pivot; a solve that updates the pivot row as the"
            f" other rows was off by 8.4e-2 on star here)")
        assert exact <= TWO_TIER_EXACT_TOL, f"paged {name}: two-tier round {exact:.3e} off exact"
        assert gap <= tol, f"paged {name}: two-tier round {gap:.3e} past {tol:.3e}"
        if name == "star":
            assert solve <= SOLVE_F64_RATIO * lib_solve, f"star: the solve is {solve:.3e} off f64"
        del rt
    # two of the four cohorts a tick: the resident runtime serves the same devices
    cfg = runtime_config(cohort_topologies(d, COHORT_CLUSTERS)["star"])
    rt, reports, tick_s, paging, counts = paged_ticks(base, cfg, host_tick, c, T,
                                                      active=COHORT_ACTIVE)
    res = FleetRuntime(fleet, cfg, device="cuda")
    res_reports = [res.tick(tick(t), served=reports[t].served) for t in range(COHORT_TICKS)]
    worst = compare_reports("paged star, two cohorts a tick", reports, res_reports,
                            after=max(LOSS_RTOL, 2 * spreads["star"]), served_only=True)
    merges = sum(r.decision.merge for r in reports)
    assert counts["fleet_ingest"] == COHORT_ACTIVE * COHORT_TICKS, counts
    rt.assert_compile_once()
    text = paging_text(paging, tick_s)
    log(f"  star, {COHORT_ACTIVE} of {rt.schedule.n_cohorts} cohorts a tick: {COHORT_TICKS} ticks,"
        f" merges {merges}, served losses max rel diff {worst:.3e}, equal flags and decisions;"
        f" tick p50 {np.median(tick_s) * 1e3:.2f} ms; {text}; on {smi}")
    for k, v in counts.items():
        if v:
            launches[k] = launches.get(k, 0) + v
    return launches


def cohort_card_vs_cpu():
    """(b) D = 64 in cohorts of 16 at the cohort bench's width: the card's
    paged ticks against the port's paged ticks on the CPU, on star,
    isolated hierarchy (6 clusters, straddling) and ring: flags and
    decisions equal, losses at phase 4's bound, after the first merge at
    the larger of that and twice the CPU's own spread between its paged and
    its resident runtime on the same ticks (the same merges in another order
    of adds)."""
    import numpy as np
    import torch

    from repro_torch.fleet import FleetArena, init_fleet
    from repro_torch.runtime import FleetRuntime

    d = COHORT_CPU_D
    rng = np.random.default_rng(SEED + 3)
    x0 = (rng.standard_normal((d, 16, COHORT_CPU_N)) * 0.5).astype(np.float32)
    fleet = init_fleet(torch.Generator().manual_seed(SEED), d, COHORT_CPU_N, COHORT_CPU_NH, x0,
                       ridge=1e-2, device="cpu")
    base = FleetArena.from_fleet(fleet)
    batches = [(rng.normal(scale=0.5, size=(d, COHORT_CPU_B, COHORT_CPU_N))
                + 2.0 * ((np.arange(d) == 3) & (t >= SHIFT_TICK))[:, None, None]).astype(np.float32)
               for t in range(COHORT_TICKS)]
    for name, topo in cohort_topologies(d, 6).items():
        cfg = runtime_config(topo)
        card = paged_ticks(base, cfg, lambda t: batches[t], COHORT_CPU_C, COHORT_CPU_B)
        cpu = paged_ticks(base, cfg, lambda t: batches[t], COHORT_CPU_C, COHORT_CPU_B,
                          device="cpu")
        card[0].assert_compile_once()
        res = FleetRuntime(fleet, cfg, device="cpu")
        spread = order_spread(cpu[1], [res.tick(batches[t]) for t in range(COHORT_TICKS)])
        after = max(LOSS_RTOL, 2 * spread)
        merged, worst = False, 0.0
        for t, (a, b) in enumerate(zip(card[1], cpu[1])):
            np.testing.assert_allclose(a.losses, b.losses, rtol=after if merged else LOSS_RTOL,
                                       atol=LOSS_ATOL,
                                       err_msg=f"card against CPU, paged {name}, tick {t}")
            assert np.array_equal(a.drifted, b.drifted) and np.array_equal(
                a.fresh_detections, b.fresh_detections), (name, t)
            assert (a.decision.merge, a.decision.participants) == (
                b.decision.merge, b.decision.participants), (name, t)
            worst = max(worst, float(np.max(np.abs(a.losses - b.losses) / np.abs(b.losses))))
            merged |= b.decision.merge
        beta = float((card[0].arena.beta - cpu[0].arena.beta).abs().max()
                     / cpu[0].arena.beta.abs().max())
        log(f"  {name}: D={d} in cohorts of {COHORT_CPU_C}, {COHORT_TICKS} ticks, merges"
            f" {sum(r.decision.merge for r in card[1])}: flags and decisions equal, losses max"
            f" rel diff {worst:.3e} (after the first merge rtol {after:.3e}; the CPU's paged"
            f" against resident spread {spread:.3e}), β after {beta:.3e} of max |β|")


def cohort_page_kernels():
    """The three kernels the paged path runs, at the page shapes of the
    cohort bench (Ñ = 4, n = m = 8, T = 4, pages of 16 384 devices): each
    against its plain version, its time by events and alone, its bound and
    the library call where one computes the same."""
    import numpy as np
    import torch

    from repro_torch.core import SLFNParams, init_oselm, invert_u
    from repro_torch.kernels import (fleet_ingest_paged, from_uv_solve, from_uv_solve_plain,
                                     masked_segment_sum_mix, masked_segment_sum_mix_plain)
    from repro_torch.kernels.fleet_ingest import fleet_ingest_plain

    c, nh, n, t = PAGE_C, PAGE_NH, PAGE_N, PAGE_T
    g = torch.Generator(device="cuda").manual_seed(SEED)
    alpha = torch.rand((n, nh), generator=g, device="cuda") * 2 - 1
    bias = torch.rand((nh,), generator=g, device="cuda") * 2 - 1
    x0 = torch.randn((c, 16, n), generator=g, device="cuda") * 0.5
    st = init_oselm(SLFNParams(alpha, bias), x0, x0, ridge=1e-2)
    window = torch.randn((c, t, n), generator=g, device="cuda") * 0.5
    got = fleet_ingest_paged(st.p, st.beta, alpha, bias, window, activation=st.activation)
    ref_st, ref_l = fleet_ingest_plain(st, window)
    _, rels = rel_err(got, (ref_st.p, ref_st.beta, ref_l))
    flops, nbytes = ingest_work(c, t, n, nh, n)
    b = bound(flops, nbytes)
    ms = cuda_ms(lambda: fleet_ingest_paged(st.p, st.beta, alpha, bias, window), 20)
    alone = {k: device_ms(lambda: fleet_ingest_paged(st.p, st.beta, alpha, bias, window), 20,
                          (k,)) for k in INGEST_KERNELS}
    total = None if None in alone.values() else sum(alone.values())
    plain = cuda_ms(lambda: fleet_ingest_plain(st, window), 3)
    log(f"  fleet_ingest_paged C={c} Ñ={nh} n=m={n} T={t}: max_rel P={rels[0]:.3e}"
        f" beta={rels[1]:.3e} loss={rels[2]:.3e} (tol {TOL['fleet_ingest']:.0e}); ms={ms:.4f}"
        f" (kernels alone {ms_text(total)}: "
        + ", ".join(f"{k} {ms_text(v)}" for k, v in alone.items())
        + f") plain_ms={plain:.4f} bound_ms={b[0]:.5f} ({b[1]})")
    assert max(rels) <= TOL["fleet_ingest"], rels
    p2, b2 = got[0], got[1]
    u = invert_u(p2, ridge=1e-2)
    u = 0.5 * (u + u.transpose(1, 2))
    w = torch.cat([u, u @ b2], dim=2).contiguous()
    mask = (torch.rand(c, generator=g, device="cuda") < 0.9).float()
    ids = np.zeros(c, np.int32)
    s = masked_segment_sum_mix(w, ids, mask, 1)
    ref = masked_segment_sum_mix_plain(w, ids, mask, 1)
    _, rels = rel_err((s,), (ref,))
    e = nh * (nh + n)
    b = bound(2 * c * e, 4 * (c * e + e + 2 * c))
    chain = c * 4 / 1.98e9 * 1e3
    wf = w.view(c, -1)
    ms = cuda_ms(lambda: masked_segment_sum_mix(w, ids, mask, 1), 50)
    alone = device_ms(lambda: masked_segment_sum_mix(w, ids, mask, 1), 20, ("segsum",))
    lib = cuda_ms(lambda: torch.mv(wf.t(), mask), 50)
    log(f"  masked_segment_sum_mix one cluster of {c} rows of ({nh}, {nh + n}): max_rel"
        f" {rels[0]:.3e} (tol {TOL['masked_segment_sum_mix']:.0e}); ms={ms:.4f} (kernel alone"
        f" {ms_text(alone)}) library_ms={lib:.4f} (torch.mv by the mask,"
        f" {library_device(lambda: torch.mv(wf.t(), mask), 20)}) bound_ms={b[0]:.5f} ({b[1]};"
        f" chain {chain:.5f})")
    assert rels[0] <= TOL["masked_segment_sum_mix"], rels
    u1, v1 = s[:, :, :nh], s[:, :, nh:]
    sol = from_uv_solve(u1, v1, ridge=1e-2)
    ref = from_uv_solve_plain(u1, v1, ridge=1e-2)
    differ = sum(mismatches(a, r) for a, r in zip(sol, ref))
    a1 = u1 + 1e-2 * torch.eye(nh, device="cuda")
    rhs = torch.cat([torch.eye(nh, device="cuda")[None], v1], dim=2)
    b = bound(solve_flops(1, nh, n), 4 * 2 * (nh * nh + nh * n))
    ms = cuda_ms(lambda: from_uv_solve(u1, v1, ridge=1e-2), 50)
    alone = device_ms(lambda: from_uv_solve(u1, v1, ridge=1e-2), 20, ("uv_solve_cluster_kernel",))
    lib = cuda_ms(lambda: torch.linalg.solve(a1, rhs), 50)
    log(f"  from_uv_solve S=1 Ñ={nh} m={n}: {differ} of {nh * (nh + n)} elements differ;"
        f" ms={ms:.4f} (kernel alone {ms_text(alone)}) library_ms={lib:.4f} (torch.linalg.solve,"
        f" {library_device(lambda: torch.linalg.solve(a1, rhs), 20)}) bound_ms={b[0]:.7f}"
        f" ({b[1]})")
    assert differ == 0, f"from_uv_solve at Ñ={nh}: {differ} elements differ"


def cohort_scale(smi):
    """(c) benchmarks/torch_fleet_cohort.py --full: D = 131 072 and
    1 048 576 in cohorts of 16 384, its claims and launches asserted."""
    from benchmarks import torch_fleet_cohort

    lines = torch_fleet_cohort.main([
        "--full", "--out", str(ROOT / "BENCH_torch_fleet_cohort.json"),
        "--history", str(ROOT / "BENCH_torch_history.jsonl")])
    for line in lines:
        log(f"  {line}")
    rows = json.loads((ROOT / "BENCH_torch_fleet_cohort.json").read_text())["rows"]
    for r in rows:
        log(f"  D={r['n_devices']}: launches {r['launches']}, arena {r['arena_mb']:.0f} MB,"
            f" init {r['init_seconds']:.2f} s, build and warm-up {r['build_seconds']:.2f} s,"
            f" merge pages in {r['merge_page_in_ms']:.2f} ms, out {r['merge_page_out_ms']:.2f} ms;"
            f" the point took {r['seconds']:.1f} s, its device-time sessions"
            f" {r['profile_seconds']:.1f} s; on {smi}")


def phase_cohort():
    """Phase 17: the cohort-paged arena on the card: (a) the har width
    against the resident runtime, (b) card against CPU, (c) the scale
    bench; the page shapes of the scale bench through the three kernels."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"  on {smi}")
    t0 = time.perf_counter()
    launches = cohort_full_width(smi)
    torch.cuda.empty_cache()
    log(f"  (a) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cohort_card_vs_cpu()
    log(f"  (b) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cohort_page_kernels()
    log(f"  the page kernels took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cohort_scale(smi)
    log(f"  (c) took {time.perf_counter() - t0:.1f} s")
    return launches


# --------------------------------- phase 18: multi-process merges (mesh)

MESH_RANKS, MESH_D, MESH_TICKS = 4, 256, 2   # 64 devices a rank, two windows of T samples
MESH_CLUSTERS = 32                          # the hierarchy: 32 clusters of 8
MESH_HOPS = (2, 64)                         # the halo: two devices, and a whole shard
MESH_MERGE_EVERY = T                        # the federation: a merge after every window
MESH_COHORT_D, MESH_COHORT_C = 2048, 512    # the cohort tier 2: one cohort a rank
MESH_TIMED = 5                              # timed merges (after one untimed)
MESH_WHERE = "4 ranks on one H100 over gloo through host memory"


def mesh_fleet(d: int):
    """The phase's fleet on the card and its windows ``tick(t)`` (D, T, n),
    made from SEED on the card the same way in every process."""
    import torch

    from repro_torch.fleet import init_fleet

    boot, tick = cohort_batches(d)
    fleet = init_fleet(torch.Generator().manual_seed(SEED), d, N_FEAT, N_HID,
                       boot.cpu().numpy(), activation="identity", ridge=RIDGE, device="cuda")
    return fleet, tick


def mesh_topologies(d: int):
    from repro_torch.fleet import all_to_all, hierarchical, star

    return {"star": star(d), "hierarchical": hierarchical(d, MESH_CLUSTERS),
            "hierarchical_isolated": hierarchical(d, MESH_CLUSTERS, head_exchange=False),
            "all_to_all": all_to_all(d)}


def mesh_federation_inputs(fleet, tick):
    """One device a rank (the first of each rank's block) and its stream:
    the device's rows of every window, one after the other."""
    import torch

    rows = torch.arange(MESH_RANKS, device="cuda") * (MESH_D // MESH_RANKS)
    devices = [fleet.replace(beta=fleet.beta[r], p=fleet.p[r]) for r in rows.tolist()]
    streams = torch.cat([tick(t)[rows] for t in range(MESH_TICKS)], dim=1).contiguous()
    return devices, streams


def mesh_rank(rank: int) -> dict:
    """One of the phase's four ranks, on card 0 over gloo: (a) training its
    block, (b) the psum merges, (c) the halo, timed merges, (d) the mesh
    federation, (e) the cohort tier 2. Returns its blocks, the merged
    models and each step's launches."""
    import numpy as np
    import torch

    from repro_torch.federated import mesh_federated_train
    from repro_torch.fleet import (
        CohortMerger, CohortSchedule, cohort_tree_reduce, fleet_merge_masked_kernel,
        fleet_merge_sharded, fleet_train_sharded, init_arena, ring, star,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import shard_fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    mesh = make_host_mesh()
    fleet, tick = mesh_fleet(MESH_D)
    devices, streams = mesh_federation_inputs(fleet, tick)
    local = shard_fleet(fleet, mesh)
    del fleet
    out = {"index": mesh.index("data"), "backend": mesh.backend, "device": str(mesh.device),
           "launches": {}, "merged": {}, "timed": {}}

    def counted(what, fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        out["launches"][what] = {k: v for k, v in launch_counts().items() if v}
        return result

    def host(st):
        return {"p": st.p.cpu().numpy(), "beta": st.beta.cpu().numpy()}

    def train():
        st = local
        for t in range(MESH_TICKS):
            st = fleet_train_sharded(st, tick(t), mesh)
        return st

    local = counted("train", train)
    out["trained"] = host(local)
    merges = dict(mesh_topologies(MESH_D))
    merges.update({f"ring hops={h}": ring(MESH_D, h) for h in MESH_HOPS})
    for name, topo in merges.items():
        merged = counted(name, lambda: fleet_merge_sharded(local, topo, mesh, ridge=RIDGE))
        out["merged"][name] = host(merged)
    try:
        fleet_merge_sharded(local, ring(MESH_D, MESH_D // MESH_RANKS + 1), mesh, ridge=RIDGE)
    except ValueError as e:
        out["halo_error"] = str(e)
    for name in ("star", "hierarchical", f"ring hops={MESH_HOPS[0]}"):
        mesh.reset_stats()
        ms = []
        for i in range(MESH_TIMED + 1):
            mesh.barrier()
            t0 = time.perf_counter()
            fleet_merge_sharded(local, merges[name], mesh, ridge=RIDGE)
            torch.cuda.synchronize()
            mesh.barrier()
            if i:
                ms.append((time.perf_counter() - t0) * 1e3)
        s = mesh.stats
        out["timed"][name] = {"ms": float(np.median(ms)),
                              "collective_ms": s.seconds * 1e3 / s.calls,
                              "bytes": s.bytes // s.calls, "staged": s.staged_bytes // s.calls}
    del local

    fed = counted("federation", lambda: mesh_federated_train(
        devices[rank], streams, mesh, merge_every=MESH_MERGE_EVERY, ridge=RIDGE))
    out["federation"] = host(fed)

    # (e) the cohort tier 2 on an arena of MESH_COHORT_D, one cohort a rank
    boot, _ = cohort_batches(MESH_COHORT_D)
    arena = init_arena(torch.Generator().manual_seed(SEED), MESH_COHORT_D, N_FEAT, N_HID,
                       lambda lo, hi: boot[lo:hi], cohort_size=MESH_COHORT_C,
                       activation="identity", ridge=RIDGE, device="cuda")
    del boot
    mask = (torch.rand(MESH_COHORT_D, generator=torch.Generator().manual_seed(SEED)) < 0.9).numpy()
    first = int(np.flatnonzero(mask)[0])
    topo, sched = star(MESH_COHORT_D), CohortSchedule(MESH_COHORT_D, MESH_COHORT_C)
    if rank == 0:  # the flat merge of the same fleet, for the spread of the paged one
        flat = fleet_merge_masked_kernel(arena.to_fleet(device="cuda"), topo,
                                         torch.from_numpy(mask.astype(np.float32)).cuda(),
                                         ridge=RIDGE)
        out["flat"] = host(flat.replace(p=flat.p[first], beta=flat.beta[first]))
        del flat
    alone = fresh_arena(arena)
    counted("cohort", lambda: CohortMerger(topo, sched, ridge=RIDGE, mesh=mesh,
                                           device="cuda").merge(arena, mask))
    CohortMerger(topo, sched, ridge=RIDGE, device="cuda").merge(alone, mask)
    scale = float(alone.beta.abs().max())
    out["cohort"] = {"p": arena.p[first].numpy(), "beta": arena.beta[first].numpy(),
                     "alone_beta": alone.beta[first].numpy(),
                     "alone": float((arena.beta - alone.beta).abs().max()) / scale,
                     "alone_p": float((arena.p - alone.p).abs().max() / alone.p.abs().max()),
                     "untouched": bool(torch.equal(arena.beta[~mask], alone.beta[~mask])),
                     "scale": scale}
    del arena, alone
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    parts = torch.randn((MESH_RANKS, N_HID, N_HID + N_FEAT), generator=g, device="cuda")
    tree = cohort_tree_reduce(parts, mesh)
    out["tree"] = tree.cpu().numpy()
    out["tree_rel"] = float((tree - cohort_tree_reduce(parts)).abs().max() / tree.abs().max())
    return out


def mesh_nccl_rank(rank: int) -> dict:
    """(f) One rank on its own card over nccl: the star's psum path against
    the single-process merge."""
    import torch

    from repro_torch.fleet import fleet_merge, fleet_merge_sharded, star
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import shard_fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    mesh = make_host_mesh()
    fleet, _ = mesh_fleet(MESH_D)
    want = fleet_merge(fleet, star(MESH_D), ridge=RIDGE)
    reset_launch_counts()
    got = fleet_merge_sharded(shard_fleet(fleet, mesh), star(MESH_D), mesh, ridge=RIDGE)
    torch.cuda.synchronize()
    return {"backend": mesh.backend, "launches": {k: v for k, v in launch_counts().items() if v},
            "equal": bool(torch.equal(got.p, want.p) and torch.equal(got.beta, want.beta)),
            "max_abs": float((got.beta - want.beta).abs().max())}


def phase_mesh(smi: str) -> dict[str, int]:
    """Phase 18: the multi-process merges, four ranks on card 0 over gloo
    (``repro_torch.launch.mesh.spawn``), against the single-process paths on
    the card, which run first, alone on the card; a one-rank nccl mesh;
    each rank's launches. Returns the launches summed over the ranks."""
    import concurrent.futures
    import functools
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import UV, from_uv, oselm_train_sequential, to_uv
    from repro_torch.fleet import fleet_merge, fleet_train, ring
    from repro_torch.launch.mesh import spawn

    # the single-process paths: training, each merge and its own spread on
    # the reversed device axis, the merges' times, the federation's chain
    fleet, tick = mesh_fleet(MESH_D)
    trained = fleet
    for t in range(MESH_TICKS):
        trained = fleet_train(trained, tick(t))
    perm = torch.arange(MESH_D - 1, -1, -1, device="cuda")
    rev = trained.replace(p=trained.p[perm].contiguous(), beta=trained.beta[perm].contiguous())
    topos = dict(mesh_topologies(MESH_D))
    topos.update({f"ring hops={h}": ring(MESH_D, h) for h in MESH_HOPS})
    single, spreads, single_ms = {}, {}, {}
    for name, topo in topos.items():
        want = fleet_merge(trained, topo, ridge=RIDGE)
        other = fleet_merge(rev, reversed_topology(topo), ridge=RIDGE)
        single[name] = {k: getattr(want, k).cpu().numpy() for k in ("p", "beta")}
        spreads[name] = {k: float((getattr(other, k)[perm] - getattr(want, k)).abs().max())
                         for k in ("p", "beta")}
        del want, other
        if name in ("star", "hierarchical", f"ring hops={MESH_HOPS[0]}"):
            torch.cuda.synchronize()
            ms = []
            for _ in range(MESH_TIMED + 1):
                t0 = time.perf_counter()
                fleet_merge(trained, topo, ridge=RIDGE)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            single_ms[name] = float(np.median(ms[1:]))
    trained_np = {k: getattr(trained, k).cpu().numpy() for k in ("p", "beta")}
    devices, streams = mesh_federation_inputs(fleet, tick)

    def chain(order):
        states = list(devices)
        for c in range(streams.shape[1] // MESH_MERGE_EVERY):
            xs = streams[:, c * MESH_MERGE_EVERY : (c + 1) * MESH_MERGE_EVERY].contiguous()
            states = [oselm_train_sequential(s, xs[i], xs[i]) for i, s in enumerate(states)]
            uvs = [to_uv(s, ridge=RIDGE) for s in states]
            u, v = uvs[order[0]].u, uvs[order[0]].v
            for i in order[1:]:
                u, v = u + uvs[i].u, v + uvs[i].v
            states = [from_uv(s, UV(u=u, v=v), ridge=RIDGE) for s in states]
        return states[0].beta.cpu().numpy()

    orders = [list(np.roll(np.arange(MESH_RANKS), k)) for k in range(MESH_RANKS)]
    chains = [chain(o) for o in [*orders, orders[0][::-1]]]
    fed_spread = max(float(np.abs(c - chains[0]).max()) for c in chains[1:])
    del fleet, trained, rev, devices, streams
    torch.cuda.empty_cache()

    # the nccl leg is skipped only where this torch has no nccl backend,
    # decided before any rank starts; any failure of a rank fails the phase
    nccl_skip = None if torch.distributed.is_nccl_available() else "torch has no nccl backend"
    t0 = time.perf_counter()
    with (tempfile.TemporaryDirectory(dir=ROOT / "build") as rdv,
          concurrent.futures.ThreadPoolExecutor(1) as pool):
        # the one-rank nccl world starts beside the four gloo ranks
        nccl_job = (None if nccl_skip else
                    pool.submit(spawn, mesh_nccl_rank, 1, rdv, device="cuda", timeout=600))
        ranks = spawn(mesh_rank, MESH_RANKS, rdv, device="cuda", timeout=600)
        nccl = None if nccl_job is None else nccl_job.result()[0]
        spawn_s = time.perf_counter() - t0
    ranks = sorted(ranks, key=lambda r: r["index"])
    assert all(r["backend"] == "gloo" and r["device"] == "cuda:0" for r in ranks), ranks[0]
    per = MESH_D // MESH_RANKS
    totals: dict[str, int] = {}
    for r in ranks:
        for counts in r["launches"].values():
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v

    def stacked(*path):
        blocks = [functools.reduce(dict.__getitem__, path, r) for r in ranks]
        return {k: np.concatenate([b[k] for b in blocks]) for k in ("p", "beta")}

    # (a) training: each rank's block against the single-process fleet_train
    got = stacked("trained")
    for k in ("p", "beta"):
        assert np.array_equal(got[k], trained_np[k]), f"sharded training differs ({k})"
    for r in ranks:
        assert r["launches"]["train"] == {"fleet_ingest": MESH_TICKS}, r["launches"]["train"]
    log(f"  (a) fleet_train_sharded, {MESH_RANKS} ranks of {per} devices, {MESH_TICKS} windows of"
        f" {T}: equal to the single-process fleet_train bit for bit; one fleet_ingest a rank a"
        " window")

    # (b), (c): each merge against the single-process one on the card at the
    # larger of 1e-4 and twice the single-process merge's own spread against
    # itself on the reversed device axis
    for name in topos:
        want, spread = single[name], spreads[name]
        got = stacked("merged", name)
        err = {k: float(np.abs(got[k] - want[k]).max()) for k in ("p", "beta")}
        tol = {k: max(1e-4, 2 * spread[k]) for k in ("p", "beta")}
        same = all(np.array_equal(got[k], want[k]) for k in ("p", "beta"))
        halo = name.startswith("ring")
        expect = {"banded_merge_solve": 1} if halo else {"segment_sum_mix": 1, "from_uv_solve": 1}
        for r in ranks:
            assert r["launches"][name] == expect, (name, r["launches"][name])
        if not halo and name != "hierarchical_isolated":  # one model, alike on every rank
            for k in ("p", "beta"):
                assert all(np.array_equal(got[k][0], row) for row in got[k]), (name, k)
        log(f"  ({'c' if halo else 'b'}) {name}: sharded against single-process max|Δβ|"
            f" {err['beta']:.3e}, max|ΔP| {err['p']:.3e}{' (bit for bit)' if same else ''};"
            f" the single-process merge on the reversed axis {spread['beta']:.3e},"
            f" {spread['p']:.3e}; bounds {tol['beta']:.3e}, {tol['p']:.3e}; launches a rank"
            f" {expect}")
        assert err["beta"] <= tol["beta"] and err["p"] <= tol["p"], f"{name}: sharded merge off"
    for r in ranks:
        assert f"halo exchange needs hops={per + 1}" in r["halo_error"], r.get("halo_error")
    log(f"  (c) hops {per + 1} (past a shard of {per}) refused: {ranks[0]['halo_error'][:60]}...")
    for name, ms in single_ms.items():
        t = ranks[0]["timed"][name]
        log(f"  {name}: sharded merge p50 {t['ms']:.3f} ms (host clock to a synchronize and a"
            f" barrier, {MESH_TIMED} runs), its collective {t['collective_ms']:.3f} ms a call"
            f" (CUDA events around it, staging included), {t['bytes']} bytes a call,"
            f" {t['staged']} bytes staged a"
            f" call; the single-process merge {ms:.3f} ms alone on the card; {MESH_WHERE},"
            f" {smi}")

    # (d) the mesh federation against the single-process chain over the
    # orders of its sum
    fed = ranks[0]["federation"]
    for r in ranks:
        assert np.array_equal(r["federation"]["beta"], fed["beta"]), "ranks' models differ"
        assert r["launches"]["federation"] == {"fleet_ingest": MESH_TICKS}, r["launches"]
    err = float(np.abs(fed["beta"] - chains[0]).max())
    log(f"  (d) mesh_federated_train, one device a rank, a merge every {MESH_MERGE_EVERY}"
        f" samples: against the single-process chain max|Δβ| {err:.3e} (bound twice its spread"
        f" over the orders of the sum, {fed_spread:.3e}); the same model on every rank")
    assert err <= 2 * fed_spread, (err, fed_spread)

    # (e) the cohort tier 2
    first = ranks[0]["cohort"]
    spread = float(np.abs(ranks[0]["flat"]["beta"] - first["alone_beta"]).max()) / first["scale"]
    for r in ranks:
        c = r["cohort"]
        assert np.array_equal(c["beta"], first["beta"]) and np.array_equal(c["p"], first["p"])
        assert c["untouched"], "a device outside the mask was written"
        assert r["launches"]["cohort"] == {"masked_segment_sum_mix": 1, "from_uv_solve": 1}
        assert np.array_equal(r["tree"], ranks[0]["tree"]) and r["tree_rel"] <= 1e-6
    tol = max(1e-5, 2 * spread)
    log(f"  (e) CohortMerger(mesh=) on star at D={MESH_COHORT_D} in pages of {MESH_COHORT_C}, one"
        f" a rank: against mesh=None max|Δβ|/max|β| {first['alone']:.3e}, P {first['alone_p']:.3e}"
        f" (bound {tol:.3e}: twice the paged merge's distance from the flat one, {spread:.3e});"
        f" the same model on every rank; cohort_tree_reduce over the mesh against the tree"
        f" {ranks[0]['tree_rel']:.3e}")
    assert first["alone"] <= tol, (first["alone"], tol)

    # (f) the nccl branch
    if nccl is None:
        log(f"  (f) a one-rank nccl mesh did not run: {nccl_skip}")
    else:
        assert nccl["backend"] == "nccl", nccl
        assert nccl["launches"] == {"segment_sum_mix": 1, "from_uv_solve": 1}, nccl["launches"]
        assert nccl["equal"], f"nccl: the star's psum path is off by {nccl['max_abs']:.3e}"
        log("  (f) a one-rank nccl mesh: the star's psum path equal to the single-process"
            f" merge bit for bit; launches {nccl['launches']}")
        for k, v in nccl["launches"].items():
            totals[k] = totals.get(k, 0) + v
    log(f"  the ranks took {spawn_s:.1f} s (spawn, import, the data and every leg; the nccl"
        f" rank beside them); launches"
        f" over the ranks {totals}")
    return totals


# ------------------------------------------------ phase 19: the rest of the model zoo

ZOO = ("xlstm-1.3b", "granite-moe-3b-a800m", "seamless-m4t-medium", "llama-3.2-vision-11b",
       "arctic-480b")
# arctic's 35 layers hold 13.8 B parameters each (25.8 GiB in bf16): one
# layer at its published widths fits the card
ZOO_DEPTH = {"arctic-480b": 1}
ZOO_PREFILLS = 2 + SERVE["rounds"]      # serve()'s two warm-up prefills, then one a round
ZOO_STEPS = SERVE["rounds"] * SERVE["new_tokens"]
ZOO_LONG = 1024                         # xLSTM's long prompt, B = 1
# flash_attention's new shapes on this path (B, Sq, Sk, H, hd, causal), bf16:
# seamless's cross attention from 512 text queries and from one decode query
# to 1024 frames and its encoder over them (H 16, hd 64); the VLM's from 512
# and from one query to 1601 patches (H 32, hd 128, kv 8 repeated);
# granite-moe's (H 24, hd 64) and arctic's (H 56, hd 128) causal prefills
ZOO_FLASH = ((4, 512, 1024, 16, 64, False), (4, 1, 1024, 16, 64, False),
             (4, 1024, 1024, 16, 64, False), (4, 512, 1601, 32, 128, False),
             (4, 1, 1601, 32, 128, False), (4, 512, 512, 24, 64, True),
             (4, 512, 512, 56, 128, True))
ZOO_GLA = (4, 512, 4, 512, 513)         # the mLSTM's prefill: B, S, H, dk = dh, dv = dh + 1
# decode logits on a float8 cache, card against CPU on the same caches: the
# attention upcasts the cache to bf16 and, as the reference does, rounds p to
# bf16 and sums p·v into bf16, where the card's and the CPU's orders of the
# sum may round an output to the other neighbour, 2^-8 of it (measured
# 8.6e-4 on reduced granite-moe; 1e-4 holds only where no such output flips)
F8_DECODE_REL = 2 ** -8


def zoo_launches(cfg, prefills: int, steps: int) -> dict[str, int]:
    """flash_attention and gla_forward launches of one serve(): a prefill
    runs the encoder (a launch a layer), every self-attention layer and
    every cross-attention layer (a dec layer both), and an mLSTM layer's
    GLA; serve() runs the encoder once more for the decode steps, and each
    step launches flash in each cross-attention layer."""
    pat = cfg.layer_pattern()
    assert "swa" not in pat and "hymba" not in pat and "hymba_swa" not in pat
    self_attn = sum(k in ("dense", "moe", "arctic", "dec") for k in pat)
    cross = pat.count("dec") + pat.count("xattn")
    enc = cfg.encoder_layers
    return {"flash_attention": prefills * (enc + self_attn + cross) + enc + steps * cross,
            "gla_forward": prefills * pat.count("mlstm")}


def zoo_kernel_rows():
    """(d) flash_attention on the zoo's new shapes and gla_forward at the
    mLSTM's, against their plain versions, SDPA alone beside flash."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import (
        flash_attention, flash_attention_plain, gla_forward, gla_forward_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    dtype = torch.bfloat16
    for b, sq, sk, h, hd, causal in ZOO_FLASH:
        q = torch.randn((b, sq, h, hd), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, sk, h, hd), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        measure_attention(
            "flash_attention", f"B={b} Sq={sq} Sk={sk} H={h} hd={hd}"
            f" {'causal' if causal else 'full'} {dtype}", dtype,
            lambda: flash_attention(q, k, v, causal=causal),
            lambda: flash_attention_plain(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
            ("flash_fwd_kernel",), flash_work(b, sq, sk, h, hd, causal, q.element_size()))
    b, s, h, dk, dv = ZOO_GLA
    q, k = (torch.randn((b, s, h, dk), generator=gen, device="cuda").to(dtype) for _ in range(2))
    v = torch.randn((b, s, h, dv), generator=gen, device="cuda").to(dtype)
    la = -F.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
    measure_attention("gla_forward", f"B={b} S={s} H={h} dk={dk} dv={dv} {dtype}", dtype,
                      lambda: gla_forward(q, k, v, la), lambda: gla_forward_plain(q, k, v, la),
                      None, WIDE_GLA_KERNELS, gla_work(b, s, h, dk, dv, q.element_size()))


def _bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def xlstm_long_prefill(cfg, params):
    """(c) one xlstm-1.3b prefill at S = ZOO_LONG, B = 1 (host clock to a
    synchronize), its sLSTM layers' token loops timed inside it (each call
    between two synchronizes): that loop's share of the prefill."""
    import numpy as np
    import torch

    import repro_torch.models.blocks as blocks
    from repro_torch.models import prefill

    tokens = torch.as_tensor(np.random.default_rng(SEED + 5).integers(0, cfg.vocab, (1, ZOO_LONG)),
                             device="cuda")
    prefill(params, cfg, tokens[:, :128], cache_len=128)      # warm the kernels and the caches
    loop = []
    plain_slstm = blocks.slstm_mix

    def timed_slstm(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_slstm(*args, **kw)
        torch.cuda.synchronize()
        loop.append(time.perf_counter() - t0)
        return out

    blocks.slstm_mix = timed_slstm
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _, _ = prefill(params, cfg, tokens, cache_len=ZOO_LONG)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        blocks.slstm_mix = plain_slstm
    assert bool(torch.isfinite(logits).all()) and len(loop) == cfg.layer_pattern().count("slstm")
    log(f"  (c) xlstm-1.3b prefill at S={ZOO_LONG}, B=1: {total * 1e3:.1f} ms; its {len(loop)}"
        f" sLSTM layers' token loops {sum(loop) * 1e3:.1f} ms of it ({sum(loop) / total:.3f})")


def serve_features(cfg, params, batches: int):
    """The features serve() scores (the warm-up rows, then each round's) for
    its first ``batches`` prefills, on the same prompts and stub embeddings,
    and each prefill's logits' finiteness."""
    import torch

    from repro_torch.launch.serve import serve_prompts, stub_frontend
    from repro_torch.models import prefill

    b, s, n = SERVE["batch"], SERVE["prompt_len"], SERVE["new_tokens"]
    warm, prompts = serve_prompts(cfg.vocab, rounds=SERVE["rounds"], batch=b, prompt_len=s,
                                  drift_round=SERVE["drift_round"], seed=SEED)
    fe = stub_frontend(cfg, None, b, SEED, torch.device("cuda"))
    feats, finite = [], True
    for p in (warm + prompts)[:batches]:
        logits, _, f = prefill(params, cfg, torch.as_tensor(p, device="cuda"), frontend=fe,
                               cache_len=s + n)
        finite &= bool(torch.isfinite(logits).all()) and bool(torch.isfinite(f).all())
        feats.append(f.cpu().double().numpy())
    return feats, finite


def exact_monitor_scores(feats, d_model: int, n_hidden: int):
    """serve()'s monitor chain in f64 (numpy) on its features: the Eq. 13 init
    on the tiled warm-up rows (ridge 1e-2), k=1 steps over them, then per
    round the score and a batch step, with serve()'s basis
    (tests/test_torch_serve.py::_exact_scores)."""
    import numpy as np
    import torch

    from repro_torch.core.elm import init_slfn
    from repro_torch.launch.serve import MONITOR_SEED_OFFSET

    basis = init_slfn(torch.Generator().manual_seed(SEED + MONITOR_SEED_OFFSET), d_model,
                      n_hidden, device="cpu")
    alpha, bias = basis.alpha.double().numpy(), basis.bias.double().numpy()
    warm = np.concatenate(feats[:2])
    x0 = np.tile(warm, (2 * n_hidden // warm.shape[0] + 1, 1))
    h0 = x0 @ alpha + bias
    a = h0.T @ h0 + 1e-2 * np.eye(n_hidden)
    p, beta = np.linalg.inv(a), np.linalg.solve(a, h0.T @ x0)
    for x in warm:
        h = x @ alpha + bias
        ph = p @ h
        p = p - np.outer(ph, ph) / (1.0 + h @ ph)
        beta = beta + np.outer(p @ h, x - h @ beta)
    scores = []
    for x in feats[2:]:
        h = x @ alpha + bias
        scores.append(float(np.mean((x - h @ beta) ** 2)))
        ph = p @ h.T
        p = p - ph @ np.linalg.inv(np.eye(len(x)) + h @ ph) @ ph.T
        beta = beta + p @ h.T @ (x - h @ beta)
    return scores


def zoo_serve(name, smi) -> dict[str, int]:
    """(a), (b) one config at its published widths: draw on the card, serve
    3 rounds, launches held to the layer pattern; returns them."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import active_param_count, init_params, param_count

    cfg = get_config(name)
    if name in ZOO_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=ZOO_DEPTH[name])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED), cfg, device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n, active = param_count(params), active_param_count(params, cfg)
    # a decode step reads every weight but the encoder's and the frontend's
    # once; an MoE step's experts are read whole by the einsum dispatch,
    # the active share of them is the floor of a dispatch that reads only
    # the routed experts
    step_bytes = _bytes({k: v for k, v in params.items()
                         if k not in ("enc_layers", "enc_norm", "frontend_proj")})
    active_bytes = step_bytes - (n - active) * params["embed"].element_size()
    log(f"  (a) {name}: {cfg.n_layers} layers{' (depth cut)' if name in ZOO_DEPTH else ''},"
        f" d_model {cfg.d_model}, {cfg.n_heads} heads (kv {cfg.n_kv_heads}, hd {cfg.head_dim}),"
        f" pattern {dict((k, cfg.layer_pattern().count(k)) for k in set(cfg.layer_pattern()))},"
        f" encoder {cfg.encoder_layers}, frontend {cfg.frontend}: {n / 1e9:.3f} B parameters"
        f" ({active / 1e9:.3f} B active a token), drawn in {draw_s:.2f} s,"
        f" {(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB,"
        f" draw peak {(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    want = zoo_launches(cfg, ZOO_PREFILLS, ZOO_STEPS)
    out, got = serve_counted(cfg, params, f"(b) {name} serve {SERVE}", ZOO_PREFILLS, 0,
                             want=want, **SERVE)
    assert all(r.tokens.shape == (SERVE["batch"], SERVE["new_tokens"] + 1) for r in out)
    scores = [r.score for r in out]
    if all(np.isfinite(scores)):
        _, finite = serve_features(cfg, params, 3)   # the warm-up and round 0
        assert finite, f"{name}: non-finite logits or features"
    else:
        # the monitor's Eq. 13 init sees 2·B distinct warm-up rows for Ñ
        # hidden units; where 2·B < Ñ, U₀ + εI has Ñ − 2·B eigenvalues at
        # ε against ~1e5, and its f32 inverse may lose definiteness (the
        # reference's own f32 monitor gives NaN there too). The model is
        # held instead: finite logits and features, and finite scores from
        # the same monitor chain in f64 on those features
        feats, finite = serve_features(cfg, params, ZOO_PREFILLS)
        exact = exact_monitor_scores(feats, cfg.d_model, cfg.detector_hidden)
        log(f"    {name}: the f32 monitor's scores {scores} at {2 * SERVE['batch']} warm-up rows"
            f" for Ñ = {cfg.detector_hidden}; the f64 chain on the same features {exact}")
        assert 2 * SERVE["batch"] < cfg.detector_hidden, f"{name}: a well-posed monitor gave NaN"
        assert finite and all(np.isfinite(exact)), f"{name}: non-finite features or exact scores"
    prefill_ms = sorted(r.prefill_seconds * 1e3 for r in out)
    decode_ms = sorted(r.decode_seconds * 1e3 / SERVE["new_tokens"] for r in out)
    log(f"    {name}: prefill {prefill_ms[1]:.2f} ms (median of {len(out)}; {prefill_ms}),"
        f" decode {decode_ms[1]:.3f} ms a token (median; {[round(x, 3) for x in decode_ms]}),"
        f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; a decode step's"
        f" floor, its weights read once at 3.35 TB/s: {step_bytes / H100_BYTES_PER_S * 1e3:.3f} ms"
        f" ({step_bytes / 2**30:.2f} GiB)"
        + (f", the routed experts' only {active_bytes / H100_BYTES_PER_S * 1e3:.3f} ms"
           if cfg.n_experts else "") + f"; {smi}")
    if name == "xlstm-1.3b":
        xlstm_long_prefill(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return got


def zoo_card_vs_cpu():
    """(e) each config reduced (f32), card against CPU on the same weights and
    stub embeddings; then a float8 KV cache: the card's prefill cache is its
    f32 cache rounded by to_f8, bit for bit, and each decode step's logits
    are the CPU's (1e-4) on the card's float8 caches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.blocks import F8, to_f8

    for name in ZOO:
        cfg = get_config(name).reduced()
        cpu = init_params(torch.Generator().manual_seed(SEED), cfg, device="cpu")
        fe = None
        if cfg.frontend is not None:
            fe = torch.from_numpy(np.random.default_rng(SEED + 6).standard_normal(
                (SERVE_CPU_B, cfg.n_frontend_tokens, cfg.d_frontend), dtype=np.float32))
        model_card_vs_cpu(cfg, cpu, f"(e) {name} reduced", frontend=fe)

    base = get_config("granite-3-2b").reduced()
    cfg = dataclasses.replace(base, kv_cache_dtype="float8_e4m3fn")
    cpu = init_params(torch.Generator().manual_seed(SEED), cfg, device="cpu")
    card = to_card(cpu)
    b, s, n = SERVE_CPU_B, SERVE_CPU_S, SERVE_CPU_STEPS
    tokens = torch.from_numpy(np.random.default_rng(SEED + 7).integers(0, cfg.vocab, (b, s))).cuda()
    _, c8, _ = prefill(card, cfg, tokens, cache_len=s + n)
    _, c32, _ = prefill(card, base, tokens, cache_len=s + n)
    for leaf in ("k", "v"):
        assert c8["dense"][leaf].dtype == F8
        assert torch.equal(c8["dense"][leaf].view(torch.uint8),
                           to_f8(c32["dense"][leaf]).view(torch.uint8)), leaf
    tok, worst = tokens[:, -1], 0.0
    for i in range(n):
        c_cpu = {"dense": {leaf: t.cpu() for leaf, t in c8["dense"].items()}}
        lg_g, c8 = decode_step(card, cfg, tok, c8, s + i, max_seq=s + n)
        lg_c, _ = decode_step(cpu, cfg, tok.cpu(), c_cpu, s + i, max_seq=s + n)
        worst = max(worst, rel_err((lg_g.cpu(),), (lg_c,))[1][0])
        tok = lg_g.argmax(-1)
    log(f"  (e) granite-3-2b reduced, float8 KV cache: the prefill's cache is to_f8 of its f32"
        f" cache bit for bit on the card; {n} decode steps card - CPU on the card's float8"
        f" caches: logits max rel {worst:.2e} (tol {F8_DECODE_REL:.1e})")
    assert worst <= F8_DECODE_REL, "float8 decode: card != CPU"


def phase_zoo(smi: str) -> dict[str, int]:
    """Phase 19; returns the launches of (b)'s serving runs."""
    log("  (d) flash_attention on the zoo's shapes and gla_forward at the mLSTM's, against"
        " their plain versions")
    zoo_kernel_rows()
    totals: dict[str, int] = {}
    for name in ZOO:
        for k, v in zoo_serve(name, smi).items():
            totals[k] = totals.get(k, 0) + v
    zoo_card_vs_cpu()
    log(f"  launches over (b): {totals}")
    return totals


# ------------------------------------------------ phase 20: training

TRAIN_ARCH = "gemma3-1b"       # the reference's train.py default
TRAIN_B, TRAIN_S, TRAIN_MERGE_EVERY = 8, 128, 5
TRAIN_STEPS = 20               # about 30 s of steps on the H100
# the flash backward alone, (B, Sq, Sk, H, hd, causal, dtype): gemma3-1b's
# global layer at the training run's shape and at S 2048 (H 4, its one kv head
# repeated), granite-3-2b's (H 32, hd 64), hd 128 (B 4, S 512, H 32), the
# VLM's cross attention (512 → 1601 patches, non-causal), one f32 case,
# Sq, Sk off the 64-row tiles (hd 96, masked in the 128 instance), hd 100
# in bf16, not a multiple of 8, which takes the CUDA cores' pair, and past hd
# 256 the wide pair, bf16 causal and f32 full with Sq ≠ Sk
TRAIN_BWD = ((8, 128, 128, 4, 256, True, "bfloat16"), (2, 2048, 2048, 4, 256, True, "bfloat16"),
             (8, 512, 512, 32, 64, True, "bfloat16"), (4, 512, 512, 32, 128, True, "bfloat16"),
             (4, 512, 1601, 32, 128, False, "bfloat16"), (2, 512, 512, 8, 256, True, "float32"),
             (3, 200, 333, 5, 96, False, "bfloat16"), (2, 70, 70, 3, 100, True, "bfloat16"),
             (2, 512, 512, 4, 320, True, "bfloat16"), (2, 256, 333, 4, 512, False, "float32"))
# max |kernel − plain| / max |plain| of each of dq, dk, dv on the card: f32
# sums in other orders (measured up to 3.1e-7); bf16 results rounded once
# from f32 values that differ in their last bits, so an entry may land on the
# other bf16 neighbour, at most one bf16 step of the largest entry's binade
BWD_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
BWD_KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")
WIDE_BWD_KERNELS = ("flash_bwd_wide_dq_kernel", "flash_bwd_wide_dkdv_kernel")
# card against CPU on the reduced configs (f32): the loss within 1e-5, each
# gradient leaf within 1e-4 of its largest |g| (tests/test_torch_train.py's
# bounds against the reference); the sgd moves past two f32 roundings of
# p − lr·g at 1e-4 of each leaf's largest move; Adam's loss and grad norm
# each config's tokens a row: gemma3-1b's past the reduced window of 64 (a
# local and a global layer), the GLA configs' past one chunk of 128
TRAIN_CPU = {"gemma3-1b": 96, "granite-moe-3b-a800m": 96, "hymba-1.5b": 200, "xlstm-1.3b": 200}
TRAIN_LOSS_ABS, TRAIN_GRAD_REL = 1e-5, 1e-4
# the GLA configs' full-width runs, (arch, B, S, steps, merge every, the loss
# must fall): S 512 is four of hymba's chunks, so the state's gradient is
# carried; xLSTM's sLSTM token loops make its steps long
TRAIN_GLA_RUNS = (("hymba-1.5b", 4, 512, 10, 5, True), ("xlstm-1.3b", 2, 256, 3, 5, False))
# the GLA backward alone, (B, S, H, dk, dv, dtype): hymba-1.5b's Mamba heads at
# the training run's shape, bf16 and f32, xLSTM's mLSTM at its training shape
# (dk 512, dv 513, past one block's tiles), S off the chunk
TRAIN_GLA = ((4, 512, 25, 16, 64, "bfloat16"), (4, 512, 25, 16, 64, "float32"),
             (2, 256, 4, 512, 513, "bfloat16"), (3, 200, 5, 16, 64, "bfloat16"))
# max |kernel − plain| / max |plain| of each of dq, dk, dv and dlog a: f32
# sums in other orders; bf16 gradients rounded once from f32 values that
# differ in their last bits (one bf16 step of the largest entry's binade)
GLA_BWD_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
# the GLA backward's kernels by route: bf16 on the tensor cores (after
# GLA_BWD_PAD where a width is not a multiple of 8), f32 on the CUDA cores
GLA_BWD_ROUTES = {"bfloat16": ("gla_bwd_state_mma_kernel", "gla_bwd_carry_kernel",
                               "gla_bwd_chunk_mma_kernel", "gla_bwd_dlog_a_kernel"),
                  "float32": ("gla_bwd_state_kernel", "gla_bwd_carry_kernel",
                              "gla_bwd_chunk_kernel", "gla_bwd_dlog_a_kernel")}
GLA_BWD_PAD = "gla_bwd_pad_kernel"
GLA_BWD_KERNELS = tuple(sorted({*GLA_BWD_ROUTES["bfloat16"], *GLA_BWD_ROUTES["float32"],
                                GLA_BWD_PAD}))


def flash_bwd_work(b, sq, sk, h, hd, causal, itemsize):
    """(operations, bytes): 10·hd a kept pair (q·k again, dout·v, pᵀ·dout,
    ds·k, dsᵀ·q, 2·hd each); q, k, v, out, dout read and dq, dk, dv written
    once (the f32 row statistics beside them)."""
    pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * sk)
    return 10 * hd * pairs, itemsize * b * h * hd * (4 * sq + 4 * sk) + 8 * b * h * sq


def split_device_ms(fn, library, reps: int, kernels: tuple[str, ...]):
    """(ms of one call of ``fn``'s kernels, ms of one ``library`` call, the
    library's longest kernel, the names of ``fn``'s kernels) from one
    torch.profiler session over ``reps`` calls of each
    (``benchmarks/torch_device_time.py``): ``fn`` launches each kernel whose
    name holds one of ``kernels`` once a call, every other kernel of the
    session is the library's. (None, None, "", []) when no session saw
    ``kernels``."""
    from benchmarks.torch_device_time import per_call_us, profile_sessions

    def mine(name):
        return any(k in name for k in kernels)

    try:
        ((by, _),) = profile_sessions(lambda: (fn(), library()), calls=reps, needs=kernels)
    except RuntimeError:
        return None, None, "", []
    own = sum(mean for name, (mean, _) in by.items() if mine(name)) / 1e3
    lib = {k: v for k, v in per_call_us(by, reps).items() if not mine(k)}
    names = [re.match(r"\w+(<[^>]*>)?", n[n.index(k):]).group(0)
             for k in kernels for n in by if k in n]
    return own, sum(lib.values()) / 1e3, max(lib, key=lib.get, default="")[:72], names


def flash_bwd_rows():
    """(a) flash_attention_bwd against its plain version at TRAIN_BWD, the
    forward with statistics bit for bit the forward without, each shape's
    route (the kernels the profiler saw: the tensor cores' ``_mma`` pair for
    bf16 at hd a multiple of 8 up to 256, every tensor here being on a
    16-byte boundary, the wide pair past 256, else the CUDA cores' pair);
    returns the kernel line's row (the
    training run's shape)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    row = None
    for b, sq, sk, h, hd, causal, dname in TRAIN_BWD:
        dtype = getattr(torch, dname)
        q = torch.randn((b, sq, h, hd), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, sk, h, hd), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        dout = torch.randn((b, sq, h, hd), generator=gen, device="cuda").to(dtype)
        out, m, l = flash_attention_fwd(q, k, v, causal=causal)
        assert torch.equal(out, flash_attention(q, k, v, causal=causal)), \
            "the forward's output moved with its statistics"
        fn = lambda: flash_attention_bwd(q, k, v, out, dout, m, l, causal=causal)  # noqa: E731
        plain = lambda: flash_attention_bwd_plain(q, k, v, out, dout, m, l, causal=causal)  # noqa: E731
        got, want = fn(), plain()
        rels = [float((g.float() - w.float()).abs().max() / w.float().abs().max())
                for g, w in zip(got, want)]
        assert all(bool(torch.isfinite(g).all()) for g in got), "non-finite gradient"
        abs_err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        # SDPA's backward alone: its graph kept, the gradient taken again and again
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        do_lib = dout.transpose(1, 2)
        library = lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do_lib,  # noqa: E731
                                              retain_graph=True)
        work = flash_bwd_work(b, sq, sk, h, hd, causal, q.element_size())
        bnd = bound(*work, H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS)
        r = dict(abs=abs_err, ms=cuda_ms(fn, 10), plain_ms=cuda_ms(plain, 2),
                 library_ms=cuda_ms(library, 10), bound_ms=bnd[0], bound_by=bnd[1])
        kernels = WIDE_BWD_KERNELS if hd > 256 else BWD_KERNELS
        alone, lib_alone, lib_kernel, names = split_device_ms(fn, library, 5, kernels)
        log(f"  (a) flash_attention_bwd B={b} Sq={sq} Sk={sk} H={h} hd={hd}"
            f" {'causal' if causal else 'full'} {dname}: max rel dq, dk, dv"
            f" {', '.join(f'{x:.2e}' for x in rels)} (tol {BWD_TOL[dname]:.1e})"
            f"  ms={r['ms']:.4f} (kernels alone {ms_text(alone)}) plain_ms={r['plain_ms']:.4f}"
            f" library_ms={r['library_ms']:.4f} (SDPA's backward; alone {ms_text(lib_alone)}:"
            f" {lib_kernel})"
            f"  bound_ms={bnd[0]:.4f} ({bnd[1]}: {work[0] / 1e9:.2f} GFLOP,"
            f" {work[1] / 1e6:.1f} MB)  route: {', '.join(names)}")
        assert all(x <= BWD_TOL[dname] for x in rels), "flash_attention_bwd: kernel != plain"
        mma = dname == "bfloat16" and hd % 8 == 0 and hd <= 256
        assert len(names) == 2 and all(n.startswith(k) for n, k in zip(names, kernels)) \
            and all(("_mma<" in n) == mma for n in names), f"flash_attention_bwd's route: {names}"
        if row is None:
            row = r
        del q, k, v, dout, out, m, l, got, want, qt, kt, vt, o_lib
    return row


def gla_bwd_work(b, s, h, dk, dv, itemsize):
    """(operations, bytes) of the GLA backward, each product counted once:
    a chunk of L tokens takes 4·L·dk·dv fused multiply-adds (ΔG, dy·S_inᵀ,
    v·Gᵀ, k·G) and, over its L(L+1)/2 kept pairs, 2·dv (dP, Pᵀ·dy) and 3·dk
    (the scores, dP·k, dPᵀ·q), 2 operations each; q, k, v and dy read and
    dq, dk and dv written once in their type, log a and dlog a, the states
    entering the chunks, their decays, dS_final and S_final in f32."""
    c = min(128, s)
    fma = sum(4 * n * dk * dv + n * (n + 1) // 2 * (2 * dv + 3 * dk)
              for n in (min(c, s - t0) for t0 in range(0, s, c)))
    chunks = -(-s // c)
    nbytes = itemsize * s * (4 * dk + 3 * dv) + 4 * (2 * s + (chunks + 2) * dk * dv + chunks)
    return 2 * fma * b * h, nbytes * b * h


def gla_bwd_route(fn, kernels: tuple[str, ...]) -> tuple[float | None, list[str]]:
    """(device ms of one call of ``fn``, the names of the gla_bwd_ kernels
    it launched) from one torch.profiler session of 5 calls
    (``benchmarks/torch_device_time.py``); (None, []) when five sessions
    missed one of ``kernels``, each launched once a call."""
    from benchmarks.torch_device_time import profile_sessions

    try:
        ((by, _),) = profile_sessions(fn, calls=5, needs=kernels)
    except RuntimeError:
        return None, []
    names = sorted({re.match(r"\w+", n[n.index("gla_bwd_"):]).group(0)
                    for n in by if "gla_bwd_" in n})
    total = 0.0
    for kernel in kernels:
        hits = [(mean, n) for name, (mean, n) in by.items() if kernel in name]
        total += sum(mean * n for mean, n in hits) / sum(n for _, n in hits)
    return total / 1e3, names


def gla_bwd_rows(smi: str):
    """(a) gla_backward against its plain version at TRAIN_GLA, with a
    final-state cotangent, on the states its forward keeps; the same bits
    on a second call; each shape's route asserted; returns the kernel line's
    row (hymba-1.5b's bf16 training shape)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import gla_backward, gla_backward_plain
    from repro_torch.kernels.gla_scan import _forward

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    row = None
    for b, s, h, dk, dv, dname in TRAIN_GLA:
        dtype = getattr(torch, dname)
        q, k = (torch.randn((b, s, h, dk), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        v, dy = (torch.randn((b, s, h, dv), generator=gen, device="cuda").to(dtype)
                 for _ in range(2))
        la = -F.softplus(torch.randn((b, s, h), generator=gen, device="cuda")) / 4
        ds = torch.randn((b, h, dk, dv), generator=gen, device="cuda")
        _, state, states, decay = _forward(q, k, v, la, keep=True)
        fn = lambda: gla_backward(q, k, v, la, dy, ds, states, decay, state)  # noqa: E731
        plain = lambda: gla_backward_plain(q, k, v, la, dy, ds, states, decay, state)  # noqa: E731
        got, again, want = fn(), fn(), plain()
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        abs_err, rels = rel_err([g.float() for g in got], [w.float() for w in want])
        work = gla_bwd_work(b, s, h, dk, dv, q.element_size())
        bnd = bound(*work, H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS)
        r = dict(abs=abs_err, ms=cuda_ms(fn, 10), plain_ms=cuda_ms(plain, 2), library_ms=None,
                 bound_ms=bnd[0], bound_by=bnd[1])
        route = GLA_BWD_ROUTES[dname] + ((GLA_BWD_PAD,) if dname == "bfloat16" and (
            dk % 8 or dv % 8) else ())
        alone, names = gla_bwd_route(fn, route)
        log(f"  (a) gla_backward B={b} S={s} H={h} dk={dk} dv={dv} {dname}, with dS_final: max rel"
            f" dq, dk, dv, dlog a {', '.join(f'{x:.2e}' for x in rels)} (tol"
            f" {GLA_BWD_TOL[dname]:.1e}), the same bits twice: {same}  ms={r['ms']:.4f} (kernels"
            f" alone {ms_text(alone)}) plain_ms={r['plain_ms']:.4f} library_ms=none"
            f"  bound_ms={bnd[0]:.4f} ({bnd[1]}: {work[0] / 1e9:.2f} GFLOP, {work[1] / 1e6:.1f} MB;"
            f" at 67 TFLOP/s {work[0] / H100_F32_FLOPS * 1e3:.4f}; {r['ms'] / bnd[0]:.1f}× the"
            f" bound) on {smi}  route: {', '.join(names) or 'not seen'}")
        assert same, "gla_backward: two calls differ"
        assert all(x <= GLA_BWD_TOL[dname] for x in rels), "gla_backward: kernel != plain"
        assert not names or names == sorted(route), f"gla_backward's route: {names}"
        if row is None:
            row = r
        del q, k, v, dy, la, ds, state, states, decay, got, again, want
    return row


def train_flash_layers(cfg, seq: int) -> int:
    """The layers whose attention a forward at ``seq`` tokens sends to
    flash_attention: every global layer, and a sliding-window layer where
    the sequence fits its window (local_attention takes it past the window),
    hymba's heads as the attention-only layers'."""
    pat = cfg.layer_pattern()
    window = pat.count("swa") + pat.count("hymba_swa")
    return pat.count("dense") + pat.count("hymba") + (window if seq <= cfg.sliding_window else 0)


def train_gla_layers(cfg) -> int:
    """The layers that run gla_forward: hymba's Mamba heads and xLSTM's mLSTM."""
    pat = cfg.layer_pattern()
    return pat.count("hymba") + pat.count("hymba_swa") + pat.count("mlstm")


def train_launches(cfg, seq: int, steps: int) -> dict[str, int]:
    """The training run's launches: a step runs each flash and each GLA
    layer's forward twice (the forward, then its recompute under the
    checkpoint in the backward) and its backward once; the detector's
    init_oselm one hidden_proj and two matmul_atb."""
    flash, gla = train_flash_layers(cfg, seq) * steps, train_gla_layers(cfg) * steps
    want = {"flash_attention": 2 * flash, "flash_attention_bwd": flash,
            "gla_forward": 2 * gla, "gla_backward": gla, "hidden_proj": 1, "matmul_atb": 2}
    return {k: v for k, v in want.items() if v}


def train_run(smi: str, arch: str, batch: int, seq: int, steps: int, merge_every: int,
              falling: bool = True) -> dict[str, int]:
    """(b) repro_torch.launch.train at full width, one nccl rank; returns its
    launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = get_config(arch)
    t0 = time.perf_counter()
    rec = train.main(["--arch", arch, "--batch", str(batch), "--seq", str(seq),
                      "--steps", str(steps), "--merge-every", str(merge_every)])
    wall = time.perf_counter() - t0
    step_ms = np.asarray(rec["step_s"]) * 1e3
    losses = rec["losses"]
    want = train_launches(cfg, seq, steps)
    got = {k: v for k, v in rec["launches"].items() if v}
    pat = cfg.layer_pattern()
    log(f"  (b) {arch} at full width ({cfg.n_layers} layers: "
        f"{', '.join(f'{pat.count(k)} {k}' for k in dict.fromkeys(pat))}; d {cfg.d_model}, vocab"
        f" {cfg.vocab}, hd {cfg.head_dim}), B {batch}, S {seq}, one rank ({rec['device']}),"
        f" {steps} steps in {wall:.1f} s (spawn and set-up included) on {smi}: loss"
        f" {losses[0]:.4f} -> {losses[-1]:.4f}; step ms p50 {np.median(step_ms):.2f}, max"
        f" {step_ms.max():.2f} (host clock to the loss on the host); peak memory"
        f" {rec['peak_bytes'] / 2**30:.2f} GiB; drift scores {rec['drifts'][0]:.4f} ->"
        f" {rec['drifts'][-1]:.4f}")
    log(f"    launches {got}, expected {want}: {train_flash_layers(cfg, seq)} layers take flash"
        f" at S {seq} (the sliding window is {cfg.sliding_window}) and"
        f" {train_gla_layers(cfg)} GLA, twice forward (remat) and once backward a step")
    assert all(np.isfinite(losses)) and (losses[-1] < losses[0] or not falling), losses
    assert got == want, f"{arch} train launches {got}, expected {want}"
    return got


def _gla_bwd_timed(pairs: list):
    """kernels.gla_scan.gla_backward with a pair of CUDA events recorded
    around each call into ``pairs`` (read after the step's synchronize)."""
    import torch

    from repro_torch.kernels import gla_scan

    plain = gla_scan.gla_backward

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = plain(*args, **kwargs)
        end.record()
        pairs.append((start, end))
        return out

    return timed


def _slstm_timed(fwd: list, bwd: list):
    """blocks.slstm_mix with each call timed between synchronizes into
    ``fwd`` (the forward and the checkpoint's recompute) and the backward
    from its output's gradient to its input's into ``bwd``; a recompute
    inside that window is the window's."""
    import torch

    import repro_torch.models.blocks as blocks

    plain, starts = blocks.slstm_mix, []

    class Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, end):
            ctx.end = end
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            torch.cuda.synchronize()
            if ctx.end:
                bwd.append(time.perf_counter() - starts.pop())
            else:
                starts.append(time.perf_counter())
            return g, None

    def timed(p, x, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, st = plain(p, Mark.apply(x, True), **kw)
        torch.cuda.synchronize()
        if not starts:
            fwd.append(time.perf_counter() - t0)
        return Mark.apply(out, False), st

    return timed


def train_profile(arch: str, batch: int, seq: int):
    """(b) the device's busy share of one full-width step: its kernels' time
    (torch.profiler) over the wall time of the step before it, in this
    process, after a step that warms it up; the backward kernels' time in
    the step. For xLSTM instead one step (phase 19 has run its kernels in
    this process) with its sLSTM layers' token loops (forward, recompute
    and backward) timed between synchronizes: their share of the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.models.blocks as blocks
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import init_params

    cfg = get_config(arch)
    gen = torch.Generator(device="cuda")
    params = init_params(gen.manual_seed(0), cfg, device="cuda")
    opt = make_optimizer(cfg, lr=1e-3)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    batch = synthetic_batch(gen, cfg.vocab, batch, seq, 0, device="cuda")

    def one():
        nonlocal params, state
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        float(met["loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    if "slstm" in cfg.layer_pattern():  # xLSTM: its sLSTM loops' share of one step
        from repro_torch.kernels import gla_scan

        fwd: list = []
        bwd: list = []
        gla: list = []
        plain_slstm, plain_gla = blocks.slstm_mix, gla_scan.gla_backward
        blocks.slstm_mix = _slstm_timed(fwd, bwd)
        gla_scan.gla_backward = _gla_bwd_timed(gla)
        try:
            step_ms = one()
        finally:
            blocks.slstm_mix, gla_scan.gla_backward = plain_slstm, plain_gla
        layers = cfg.layer_pattern().count("slstm")
        assert len(bwd) == layers and layers <= len(fwd) <= 2 * layers, (len(fwd), len(bwd))
        assert len(gla) == train_gla_layers(cfg), len(gla)
        loops = (sum(fwd) + sum(bwd)) * 1e3
        gla_ms = sum(a.elapsed_time(b) for a, b in gla)
        log(f"  (b) {arch}: a step in this process with its {layers} sLSTM layers' token loops"
            f" timed between synchronizes: {step_ms:.1f} ms, the loops {loops:.1f} ms of it"
            f" ({loops / step_ms:.3f}): forward and recompute {sum(fwd) * 1e3:.1f} ms, backward"
            f" {sum(bwd) * 1e3:.1f} ms; the GLA backward (CUDA events around its {len(gla)}"
            f" calls) {gla_ms:.2f} ms ({gla_ms / len(gla):.4f} a call, {gla_ms / step_ms:.4f} of"
            " the step)")
        return
    log(f"  (b) {arch}: a first step in this process: {one() / 1e3:.2f} s")
    plain_ms = one()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_ms = one()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not dev_ms:
        log(f"  (b) {arch}: one step profiled: wall {wall_ms:.2f} ms, device time not measured")
    else:
        log(f"  (b) {arch}: one step: wall {plain_ms:.2f} ms, then {wall_ms:.2f} ms under the"
            f" profiler; device {dev_ms:.2f} ms (the kernels' sum): busy share"
            f" {dev_ms / plain_ms:.3f} of the step ({dev_ms / wall_ms:.3f} of the profiled one)")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
        for what, names in (("the flash backward", BWD_KERNELS),
                            ("the GLA backward", GLA_BWD_KERNELS)):
            mine = [e for e in events if any(k in e.key for k in names)]
            if not mine:
                continue
            ms = sum(e.self_device_time_total for e in mine) / 1e3
            n = max(e.count for e in mine)
            log(f"  (b) {arch}: {what} in the step: {ms:.3f} ms over {n} calls ({ms / n:.4f} ms"
                f" a call: {', '.join(sorted(e.key[:48] for e in mine))}), {ms / dev_ms:.3f} of"
                " the step's kernels")


def _train_rel(got, want) -> float:
    scale = float(want.abs().max())
    return float((got.cpu() - want).abs().max()) / (scale if scale else 1.0)


def train_card_vs_cpu():
    """(c) the reduced configs in f32 on the same weights and tokens, card
    against CPU, with torch's deterministic algorithms on: without them a
    PyTorch op of the step adds in an order that changes from run to run on
    the card, and reduced hymba's sgd moves drift between 6.2e-5 and 1.09e-4
    of the bound's 1e-4 (H100; the same 7.23e-5 on every run with them)."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _train_card_vs_cpu()
    finally:
        torch.use_deterministic_algorithms(False)


def _train_card_vs_cpu():
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_and_grads, make_optimizer, make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import sgd, tree_leaves

    for name, seq in TRAIN_CPU.items():
        cfg = get_config(name).reduced()
        cpu = init_params(torch.Generator().manual_seed(SEED), cfg, device="cpu")
        card = to_card(cpu)
        rng = np.random.default_rng(SEED + 20)
        batches = [{k: torch.as_tensor(rng.integers(0, cfg.vocab, (4, seq)))
                    for k in ("tokens", "labels")} for _ in range(2)]
        on = [{k: v.cuda() for k, v in b.items()} for b in batches]

        def grads(params, b):
            loss, _, g = loss_and_grads(cfg, params, b["tokens"], b["labels"])
            return loss, tree_leaves(g)

        (lc, gc), (lg, gg) = grads(cpu, batches[0]), grads(card, on[0])
        worst = max(_train_rel(g, c) for g, c in zip(gg, gc))
        dl = abs(float(lg) - float(lc))
        log(f"  (c) {name} reduced, S {seq}: lm_loss card {float(lg):.6f} CPU {float(lc):.6f}"
            f" (|Δ| {dl:.2e}, bound {TRAIN_LOSS_ABS}); the worst gradient leaf {worst:.2e} of its"
            f" max |g| (bound {TRAIN_GRAD_REL})")
        assert dl <= TRAIN_LOSS_ABS and worst <= TRAIN_GRAD_REL

        def run(c, params, opt, bs):
            fn, st, out = make_train_step(c, opt), opt.init(params), []
            for b in bs:
                params, st, met = fn(params, st, b)
                out.append((params, float(met["loss"]), float(met["grad_norm"])))
            return out

        for label, micro, make in (("sgd", 1, lambda c: sgd(0.5)),
                                   ("make_optimizer", 1, lambda c: make_optimizer(c, 1e-3)),
                                   ("sgd, 2 micro-batches", 2, lambda c: sgd(0.5))):
            c = dataclasses.replace(cfg, num_microbatches=micro)
            steps = 2 if micro == 1 else 1
            want = run(c, cpu, make(c), batches[:steps])
            got = run(c, card, make(c), on[:steps])
            dls = [abs(g[1] - w[1]) for g, w in zip(got, want)]
            dns = [abs(g[2] - w[2]) / w[2] for g, w in zip(got, want)]
            text = (f"  (c) {name} {label}: {steps} steps, loss |Δ| {max(dls):.2e},"
                    f" grad norm {max(dns):.2e}")
            assert max(dls) <= TRAIN_LOSS_ABS and max(dns) <= TRAIN_GRAD_REL, text
            if label.startswith("sgd"):
                worst = 0.0
                for g, w, p0 in zip(tree_leaves(got[-1][0]), tree_leaves(want[-1][0]),
                                    tree_leaves(cpu)):
                    move = float((w - p0).abs().max())
                    rounding = 2 * float(np.spacing(np.float32(w.abs().max())))
                    if move > 0:
                        worst = max(worst, (float((g.cpu() - w).abs().max()) - rounding) / move)
                text += f"; the worst leaf's move off by {worst:.2e} of it past f32 rounding"
                assert worst <= TRAIN_GRAD_REL, text
            log(text + f" (bounds {TRAIN_LOSS_ABS}, {TRAIN_GRAD_REL})")


# phase 20 (e): the dry run's per-device counts (FLOPs, bytes, collective
# bytes) as the CPU-only test host counts them (torch 2.13.0+cpu): the
# detector on the 16 × 16 layout and gemma3-1b × decode_32k
DRYRUN_COUNTS = {"oselm-detector": (998244352.0, 62456378.0, 2162688.0),
                 "gemma3-1b": (20660092928.0, 26296786104.0, 0.0)}


def train_dryrun():
    """(e) the dry run on the host, fake tensors only: the detector's
    collective bytes a device equal to its U/V payload, and every count
    equal to ``DRYRUN_COUNTS``."""
    import tempfile

    from repro_torch.launch import dryrun, dryrun_detector

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        recs = [dryrun_detector.run(False, out_dir=Path(d)),
                dryrun.run_combo("gemma3-1b", "decode_32k", multi_pod=False, out_dir=Path(d))]
    seconds = time.perf_counter() - t0
    det = recs[0]
    assert det["coll_bytes_per_device"] == det["uv_payload_bytes"], det
    for rec in recs:
        got = tuple(rec[k] / rec["chips"] for k in ("hlo_flops", "hlo_bytes", "coll_bytes"))
        log(f"  (e) dry run {rec['arch']} × {rec['shape']} × {rec['mesh']}: per device"
            f" {got[0]:.6e} FLOPs, {got[1]:.6e} bytes, {got[2]:.6e} collective bytes"
            f" (the test host's {DRYRUN_COUNTS[rec['arch']]}), dominant {rec['dominant']}")
        assert got == DRYRUN_COUNTS[rec["arch"]], (rec["arch"], got)
    log(f"  (e) the dry run took {seconds:.1f} s on the host")


def train_gla_function():
    """(d) gla_forward on CUDA inputs that require a gradient: GLAForward, one
    gla_backward launch, the gradients the CPU's within TRAIN_GRAD_REL of
    each one's largest."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import gla_forward, launch_counts

    gen = torch.Generator().manual_seed(SEED + 22)
    x = [torch.randn(shape, generator=gen) for shape in ((2, 200, 3, 16), (2, 200, 3, 16),
                                                         (2, 200, 3, 64))]
    x.append(-F.softplus(torch.randn((2, 200, 3), generator=gen)) / 4)
    dy, ds = torch.randn((2, 200, 3, 64), generator=gen), torch.randn((2, 3, 16, 64), generator=gen)
    grads = {}
    for where in ("cpu", "cuda"):
        leaves = [t.detach().to(where).requires_grad_(True) for t in x]
        y, st = gla_forward(*leaves)
        assert type(y.grad_fn).__name__ == "GLAForwardBackward", type(y.grad_fn)
        before = launch_counts()["gla_backward"]
        ((y * dy.to(where)).sum() + (st * ds.to(where)).sum()).backward()
        launched = launch_counts()["gla_backward"] - before
        assert launched == (where == "cuda"), f"{where}: {launched} gla_backward launches"
        grads[where] = [t.grad for t in leaves]
    rels = [_train_rel(g, c) for g, c in zip(grads["cuda"], grads["cpu"])]
    log(f"  (d) gla_forward on CUDA inputs that require a gradient: GLAForward, one gla_backward"
        f" launch; dq, dk, dv, dlog a against the CPU's {', '.join(f'{r:.2e}' for r in rels)}"
        f" (bound {TRAIN_GRAD_REL})")
    assert all(r <= TRAIN_GRAD_REL for r in rels)


def phase_train(smi: str) -> tuple[dict, dict, dict[str, int]]:
    """Phase 20; returns the kernel line's flash_attention_bwd and
    gla_backward rows and the training runs' launches."""
    t0 = time.perf_counter()
    log("  (a) the flash backward alone against its plain version, SDPA's backward beside it")
    row = flash_bwd_rows()
    log("  (a) the GLA backward alone against its plain version")
    gla_row = gla_bwd_rows(smi)
    parts = [f"(a) {time.perf_counter() - t0:.1f} s"]
    launches: dict[str, int] = {}
    for arch, batch, seq, steps, merge_every, falling in (
            (TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_MERGE_EVERY, True),
            *TRAIN_GLA_RUNS):
        t1 = time.perf_counter()
        for k, v in train_run(smi, arch, batch, seq, steps, merge_every, falling).items():
            launches[k] = launches.get(k, 0) + v
        train_profile(arch, batch, seq)
        parts.append(f"(b) {arch} {time.perf_counter() - t1:.1f} s")
    t3 = time.perf_counter()
    train_card_vs_cpu()
    train_gla_function()
    parts.append(f"(c) and (d) {time.perf_counter() - t3:.1f} s")
    t4 = time.perf_counter()
    train_dryrun()
    log(f"  phase 20's parts: {', '.join(parts)}, (e) {time.perf_counter() - t4:.1f} s")
    return row, gla_row, launches


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

    log("phase 10: wide layers (Ñ = 384 end to end, the kernels at Ñ = 320, 768 and"
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

    log("phase 14: the port's benchmarks (kernel_bench, merge_loss, ablation_hidden,"
        " rocauc_grid, fleet_scale and its merge bench, fleet_ingest) at their full grids")
    t0 = time.perf_counter()
    phase_benchmarks()
    log(f"  phase 14 took {time.perf_counter() - t0:.1f} s")

    log("phase 15: strided and mixed-type operands (hidden_proj, segment_sum_mix,"
        " flash_attention) against their plain versions")
    t0 = time.perf_counter()
    phase_operands()
    log(f"  phase 15 took {time.perf_counter() - t0:.1f} s")

    log("phase 16: the async serving front-end at the har width (the steady leg, the"
        " crash leg, card against CPU)")
    t0 = time.perf_counter()
    for k, v in phase_serving_frontend(fleet, ticks_np).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 16 took {time.perf_counter() - t0:.1f} s")

    log("phase 17: the cohort-paged arena (CohortFleetRuntime against the resident runtime at"
        " the har width, card against CPU, the page kernels, torch_fleet_cohort --full)")
    t0 = time.perf_counter()
    for k, v in phase_cohort().items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 17 took {time.perf_counter() - t0:.1f} s")

    log("phase 18: multi-process merges, four ranks on card 0 over gloo (fleet_train_sharded,"
        " fleet_merge_sharded and its halo, the mesh federation, the cohort tier 2) against the"
        " single-process paths, and a one-rank nccl mesh")
    t0 = time.perf_counter()
    for k, v in phase_mesh(smi).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 18 took {time.perf_counter() - t0:.1f} s")

    log("phase 19: the rest of the model zoo at full width (xlstm-1.3b, granite-moe-3b-a800m,"
        " seamless-m4t-medium, llama-3.2-vision-11b, arctic-480b at one layer): serving,"
        " launches, the new attention shapes, card against CPU")
    t0 = time.perf_counter()
    for k, v in phase_zoo(smi).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 19 took {time.perf_counter() - t0:.1f} s")

    log(f"phase 20: training {TRAIN_ARCH}, hymba-1.5b and xlstm-1.3b at full width (the flash"
        " and GLA backwards, the training runs, profiled steps, card against CPU, GLAForward on"
        " the card)")
    t0 = time.perf_counter()
    rows["flash_attention_bwd"], rows["gla_backward"], train_counts = phase_train(smi)
    for k, v in train_counts.items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 20 took {time.perf_counter() - t0:.1f} s")

    log(f"phase 21: kernels (phases 1-20 took {time.perf_counter() - start:.1f} s)")
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
        # no pallas_call: the reference's custom VJP, _fa_backward_impl
        "flash_attention_bwd": ("src/repro_torch/csrc/flash_attn_bwd.cu",
                                "src/repro/models/layers.py:192"),
        # no pallas_call: jax's autodiff of the reference's chunked_linear_attention
        "gla_backward": ("src/repro_torch/csrc/gla_scan_bwd.cu", "src/repro/models/ssm.py:33"),
    }
    log("  " + ", ".join(f"{k}: {v} launches" for k, v in launches.items()))
    log("  gla_backward's kernels: bf16 " + ", ".join(GLA_BWD_ROUTES["bfloat16"]) +
        f" ({GLA_BWD_PAD} first where a width is not a multiple of 8); f32 " +
        ", ".join(GLA_BWD_ROUTES["float32"]))
    kernels = []
    for name, r in rows.items():
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["abs"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    assert len(kernels) == len(sources) == 17, f"{len(kernels)} kernels in the list"
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
