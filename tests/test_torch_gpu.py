"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Run with ``python -m pytest -m gpu tests/test_torch_gpu.py`` on a
machine with a CUDA device and ``nvcc``; without a card every test skips
(decided inside the ``cuda`` fixture, so every worker collects the same
tests).

Tolerances are max |kernel − plain| / max |plain| of each output tensor
on its own, with the reasons of ``chip_smoke.py``: 1e-6 for the
fixed-order masked segment sum, 1e-5 for the Gauss-Jordan solves (the
same fused elimination in both), 1e-4 for the ingest (other summation
orders in the GEMM and dot products, amplified along the RLS chain).
Both solves keep the pivot row out of its own step and stay within 4× of
``torch.linalg.solve``'s distance from an f64 solve at the har width.
``quantize_pack``, ``robust_segment_sum_mix``, ``dense_mix``,
``segment_sum_mix``, ``segment_broadcast`` and ``banded_mix`` are held
bit for bit: their plain versions repeat the kernels' operations in the
kernels' order. So are ``rank1_add`` and ``k1_update`` (one rounded
product, one fused multiply-add in both; ``k1_update``'s two sums in one
lane-then-butterfly order in both). ``hidden_proj`` and ``matmul_atb`` are held at
1e-6 of max |plain|, f32 or bf16 inputs (widened to f32 exactly in both):
each kernel sums in a fixed order of its own, the plain version is a
PyTorch product (a batch of eight, at 1e-6 of an f64 product's largest
entry), and both give the same bits on a second call (their slices of
the contracted axis are added in a fixed order). For ``hidden_proj`` the
scale is the larger of max |plain| and max |x·α + b|: a saturating
activation shrinks the output but not the rounding of the product under
it. ``flash_attention`` and
``gla_forward`` are held row by row (a query's output, a token's y, a
row of the state), each row at its own max |plain|, so that late query
rows, whose values are a fraction of row 0's, count as much: flash at
1e-5 in f32 (the plain version's dot products are PyTorch's, in other
orders) and 2e-2 in bf16 (a p or an output that rounds to the other bf16
neighbour), GLA at 1e-5 and 2^-8 (its plain version repeats the kernels'
arithmetic, its products summed in PyTorch's order); the GLA backward
(``gla_backward``) each gradient at 1e-5 of its largest in f32 and 2^-7
in bf16, the same bits on a second call, and ``gla_forward`` on operands
that require a gradient runs ``GLAForward`` to the CPU's gradients.
``banded_merge_solve``
is held bit for bit at the har width: its loader sums each band in the
plain version's order and its elimination is ``from_uv_solve``'s; both
solves stay bit for bit past Ñ = 320, where they take the blocked wide
solve. The
model's prefill and decode on the card are held to the CPU's at 1e-4
(reduced hymba-1.5b, f32), and two training steps of reduced gemma3-1b,
granite-moe, hymba-1.5b and xlstm-1.3b to the CPU's. A registered activation (a new name, or a
built-in name registered again) goes through ``hidden_proj`` (k=1 and
split) and ``fleet_ingest`` in one launch, at their plain versions'
bounds; a snapshot written on the card restores on the CPU bit for bit,
and the reverse, and ticks on at ``chip_smoke.py`` phase 4's bounds. The
fleet-scale benchmarks' shapes (D = 4096 fleets of (32, 80) payloads,
4096 systems at Ñ = 32, the ingest at n = m = 64) are held at the same
bounds. The serving front-end (``repro_torch.serve``) serves twelve
one-window waves at D = 16 on the card: every ack ok, the acks those of
the same waves through the CPU front-end (scores at phase 4's bounds),
the warm-up on the tick worker's thread with no library load after it,
and one ``fleet_ingest`` launch a tick and one ``banded_merge_solve`` a
merge round.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import SLFNParams, init_oselm
from repro_torch.fleet import Topology, all_to_all, hierarchical, ring, star
from repro_torch.kernels import (
    banded_merge_solve,
    banded_merge_solve_plain,
    banded_mix,
    banded_mix_plain,
    dense_mix,
    dense_mix_plain,
    flash_attention,
    flash_attention_plain,
    fleet_ingest,
    fleet_ingest_plain,
    from_uv_solve,
    from_uv_solve_plain,
    gla_forward,
    gla_forward_plain,
    hidden_proj,
    hidden_proj_plain,
    k1_update,
    k1_update_plain,
    launch_counts,
    masked_segment_sum_mix,
    masked_segment_sum_mix_plain,
    matmul_atb,
    matmul_atb_plain,
    oselm_step_k1_kernel,
    oselm_step_k1_plain,
    quantize_pack,
    quantize_pack_plain,
    rank1_add,
    rank1_add_plain,
    robust_segment_sum_mix,
    robust_segment_sum_mix_plain,
    segment_broadcast,
    segment_broadcast_plain,
    segment_sum_mix,
    segment_sum_mix_plain,
    topology_mix,
    uv_from_batch_kernel,
    uv_from_batch_plain,
)
from repro_torch.core.activations import ACTIVATION_CODES, get_activation
from repro_torch.kernels import _lib
from repro_torch.kernels.fleet_ingest import INGEST_CHUNK, ingest_chunk
from repro_torch.kernels.topology_merge import _starts_on

pytestmark = pytest.mark.gpu

D_ODD, T_ODD, F_ODD, NH_ODD = 13, 17, 37, 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _rel(got, want):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max())


def _row_rel(got, want):
    """max over the rows of the last axis of max |got − want| / max |want|
    within the row."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    assert torch.isfinite(got).all()
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())


def _fleet(cuda, activation, forget, *, d=D_ODD, n=F_ODD, nh=NH_ODD, seed=0):
    rng = np.random.default_rng(seed)
    params = SLFNParams(
        torch.from_numpy(rng.uniform(-1, 1, (n, nh)).astype(np.float32)).to(cuda),
        torch.from_numpy(rng.uniform(-1, 1, nh).astype(np.float32)).to(cuda),
    )
    x0 = torch.from_numpy(rng.uniform(-1, 1, (d, 4 * nh, n)).astype(np.float32)).to(cuda)
    ridge = 5e-2 if activation == "sigmoid" else 1e-3
    return init_oselm(params, x0, x0, activation=activation, ridge=ridge, forget=forget)


@pytest.mark.parametrize("activation,forget", [
    ("identity", 1.0), ("identity", 0.95), ("sigmoid", 1.0), ("tanh", 0.97),
])
def test_ingest_kernel_matches_plain(cuda, activation, forget):
    fleet = _fleet(cuda, activation, forget)
    win = torch.from_numpy(
        np.random.default_rng(1).uniform(-1, 1, (D_ODD, T_ODD, F_ODD)).astype(np.float32)
    ).to(cuda)
    before = launch_counts()["fleet_ingest"]
    got, loss = fleet_ingest(fleet, win)
    torch.cuda.synchronize()
    assert launch_counts()["fleet_ingest"] == before + 1
    ref, ref_loss = fleet_ingest_plain(fleet, win)
    assert _rel(got.p, ref.p) < 1e-4
    assert _rel(got.beta, ref.beta) < 1e-4
    assert _rel(loss, ref_loss) < 1e-4


# the edges of the kernel's chunks and of its P tiles: one sample; a window
# of two chunks (the second ragged) and of three; Ñ = 16, 32 and 64 (the
# smaller register tiles), 160 and 200 (P's rows over an 8-block cluster);
# the wide layer, Ñ = 256 and 320 at n = 561, T = 32 (one chunk of 32) and
# 70 (three chunks, the last ragged), λ 1 and 0.95; past the cluster's
# P chain (P in global memory, β streamed), Ñ = 321 (one row past it) and
# 768 (the mnist_like width's widest bottleneck), and Ñ = 384 with
# supervised targets across two chunks; supervised targets
# (m ≠ n) at m = 23, 70 and 300, none a multiple of the 64-column β tile;
# λ < 1; Ñ = 5 in a P tile of 32 rows; and fleets large enough that a block
# takes a run of tiles, with the next tile in a second buffer (D = 100) or,
# at Ñ = 200, in the one buffer
@pytest.mark.parametrize("d,t,n,nh,m,activation,forget", [
    (5, 1, 37, 10, None, "identity", 0.95),
    (5, 17, 20, 5, None, "identity", 0.95),
    (5, 70, 37, 10, None, "identity", 0.95),
    (5, 150, 37, 10, None, "sigmoid", 1.0),
    (5, 17, 37, 16, None, "tanh", 0.97),
    (5, 17, 61, 32, None, "identity", 1.0),
    (5, 33, 90, 64, 23, "identity", 0.95),
    (5, 9, 200, 160, None, "identity", 1.0),
    (5, 70, 37, 10, 70, "sigmoid", 0.95),
    (100, 150, 300, 10, None, "identity", 0.95),
    (70, 70, 240, 200, 300, "identity", 1.0),
    (6, 32, 561, 256, None, "identity", 1.0),
    (6, 70, 561, 256, None, "identity", 0.95),
    (6, 32, 561, 320, None, "identity", 0.95),
    (6, 70, 561, 320, 300, "identity", 1.0),
    (4, 32, 561, 321, None, "identity", 1.0),
    (3, 40, 400, 384, 300, "identity", 0.95),
    (3, 32, 800, 768, None, "identity", 1.0),
])
def test_ingest_kernel_at_its_edges(cuda, d, t, n, nh, m, activation, forget):
    rng = np.random.default_rng(8)
    params = SLFNParams(
        torch.from_numpy(rng.uniform(-1, 1, (n, nh)).astype(np.float32)).to(cuda),
        torch.from_numpy(rng.uniform(-1, 1, nh).astype(np.float32)).to(cuda),
    )
    x0 = torch.from_numpy(rng.uniform(-1, 1, (d, 4 * nh, n)).astype(np.float32)).to(cuda)
    t0 = x0 if m is None else torch.from_numpy(
        rng.uniform(-1, 1, (d, 4 * nh, m)).astype(np.float32)).to(cuda)
    ridge = 5e-2 if activation == "sigmoid" else 1e-3
    fleet = init_oselm(params, x0, t0, activation=activation, ridge=ridge, forget=forget)
    win = torch.from_numpy(rng.uniform(-1, 1, (d, t, n)).astype(np.float32)).to(cuda)
    tgt = None if m is None else torch.from_numpy(
        rng.uniform(-1, 1, (d, t, m)).astype(np.float32)).to(cuda)
    before = launch_counts()["fleet_ingest"]
    got, loss = fleet_ingest(fleet, win, tgt)
    torch.cuda.synchronize()
    assert launch_counts()["fleet_ingest"] == before + 1
    ref, ref_loss = fleet_ingest_plain(fleet, win, tgt)
    assert _rel(got.p, ref.p) < 1e-4
    assert _rel(got.beta, ref.beta) < 1e-4
    assert _rel(loss, ref_loss) < 1e-4
    again, loss2 = fleet_ingest(fleet, win, tgt)
    assert torch.equal(again.beta, got.beta) and torch.equal(loss2, loss)


def test_ingest_kernel_at_har_width(cuda):
    fleet = _fleet(cuda, "identity", 1.0, d=8, n=561, nh=128)
    win = torch.from_numpy(
        np.random.default_rng(2).uniform(-1, 1, (8, 32, 561)).astype(np.float32)
    ).to(cuda)
    got, loss = fleet_ingest(fleet, win)
    ref, ref_loss = fleet_ingest_plain(fleet, win)
    assert _rel(got.p, ref.p) < 1e-4
    assert _rel(got.beta, ref.beta) < 1e-4
    assert _rel(loss, ref_loss) < 1e-4


def test_ingest_chunk_is_the_kernels(cuda):
    """The plain version chunks the window as the kernel does, at every Ñ
    up to 1024 (the cluster's P chain to 320, the wide kernels past it)."""
    lib = _lib.library()
    for nh in range(1, 1025):
        assert lib.repro_ingest_chunk(nh) == ingest_chunk(nh), nh
    assert ingest_chunk(128) == INGEST_CHUNK


def test_masked_segment_sum_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((D_ODD, 10, 37)).astype(np.float32)).to(cuda)
    cids = np.array([0] * 4 + [2] * 6 + [3] * 3, np.int32)
    mask = torch.from_numpy((rng.random(D_ODD) < 0.7).astype(np.float32)).to(cuda)
    got = masked_segment_sum_mix(w, cids, mask, 4)
    ref = masked_segment_sum_mix_plain(w, cids, mask, 4)
    assert _rel(got, ref) <= 1e-6
    assert not got[1].any()
    with pytest.raises(ValueError, match="sorted"):
        masked_segment_sum_mix(w, cids[::-1].copy(), mask, 4)


def _spd(rng, s, n, cuda):
    a = rng.standard_normal((s, n, 3 * n)).astype(np.float32)
    return torch.from_numpy(a @ a.transpose(0, 2, 1) / (3 * n)).to(cuda)


# (32, 128, 561): the cluster solves of an isolated hierarchy at har width;
# (256, 128, 561): the stale runtime's per-device solves; (1, 16, 16) and
# (32, 32, 64): the scenarios' widths; Ñ = 37, 80 and 129: rows that fill
# neither a warp nor the last row register (80 in a tile of 128 rows);
# Ñ = 224, the largest the cluster solve takes, with its V columns split
# over two clusters
@pytest.mark.parametrize("s,n,m", [
    (1, 10, 23), (3, 10, 23), (2, 128, 561), (32, 128, 561), (256, 128, 561),
    (1, 16, 16), (32, 32, 64), (3, 37, 50), (2, 80, 100), (2, 129, 200), (2, 224, 561),
    (1, 224, 0),
])
def test_from_uv_solve_kernel_matches_plain(cuda, s, n, m):
    rng = np.random.default_rng(4)
    u = _spd(rng, s, n, cuda)
    v = torch.from_numpy(rng.standard_normal((s, n, m)).astype(np.float32)).to(cuda)
    w = torch.cat([u, v], dim=2)  # the solve reads column slices of a packed [U | V]
    before = launch_counts()["from_uv_solve"]
    p, b = from_uv_solve(w[:, :, :n], w[:, :, n:], ridge=1e-3)
    torch.cuda.synchronize()
    assert launch_counts()["from_uv_solve"] == before + 1
    rp, rb = from_uv_solve_plain(u, v, ridge=1e-3)
    assert _rel(p, rp) < 1e-5
    if m:
        assert _rel(b, rb) < 1e-5
    p2, b2 = from_uv_solve(w[:, :, :n], w[:, :, n:], ridge=1e-3)
    assert torch.equal(p, p2) and torch.equal(b, b2)


def _double_rounding_uv(rng, s, n, m):
    """SPD systems on which a fused multiply-add emulated by rounding the
    f64 sum to f32 rounds twice: with A[0, 0] = 1 (after the ridge), the
    first step's update of rows 0 and 1 of V is (1 + 2^-23) − A[1, 0]·V[0, j]
    = 1 + 2^-23 + 2^-24·(1 − 2^-46), whose f64 sum is the midpoint between
    two f32 values and whose exact value is not."""
    a = rng.standard_normal((s, n, 3 * n)).astype(np.float32)
    u = a @ a.transpose(0, 2, 1) / (3 * n)
    u[:, 0, 0] = np.float32(1) - np.float32(1e-3)
    u[:, 0, 1] = u[:, 1, 0] = np.float32(-(2.0**-12) * (1 + 2**-23))
    v = rng.standard_normal((s, n, m)).astype(np.float32)
    v[:, 0] = np.float32(2.0**-12 * (1 - 2**-23))
    v[:, 1] = np.float32(1 + 2**-23)
    return torch.from_numpy(u), torch.from_numpy(v)


# the kernel's fused multiply-add rounds once, and so does the plain
# version's: no element differs, where an update rounded twice moves a large
# share of β (more than a quarter: 125 of 256 elements at (1, 16, 16) with
# the pivot row left out of its own step, more than half before)
@pytest.mark.parametrize("s,n,m", [(32, 128, 561), (1, 16, 16)])
def test_from_uv_solve_is_exact_where_a_double_rounding_would_show(cuda, s, n, m):
    u, v = _double_rounding_uv(np.random.default_rng(4), s, n, m)
    w = torch.cat([u, v], dim=2).to(cuda)
    p, b = from_uv_solve(w[:, :, :n], w[:, :, n:], ridge=1e-3)
    rp, rb = from_uv_solve_plain(u.to(cuda), v.to(cuda), ridge=1e-3)
    assert int((p != rp).sum()) == 0 and int((b != rb).sum()) == 0
    a = u.to(cuda) + 1e-3 * torch.eye(n, device=cuda)
    eye = torch.eye(n, device=cuda)
    x = torch.cat([a, eye.expand(s, n, n), v.to(cuda)], dim=2)
    piv = torch.empty((s, n, 1), device=cuda)
    for k in range(n):  # the same elimination, each update rounded twice
        piv[:, k] = x[:, k, k : k + 1]
        row = x[:, k : k + 1] / piv[:, k : k + 1]
        upd = (x.double() - x[:, :, k : k + 1].double() * row.double()).float()
        upd[:, k : k + 1] = x[:, k : k + 1]
        x = upd
    x = x * (1.0 / piv)
    assert int((x[:, :, 2 * n :] != rb).sum()) > rb.numel() // 4


# the shapes of chip_smoke.py's phase 2 (the har width, Ñ = 128, m = 561:
# one star system, the 32 cluster sums of a hierarchy, 256 per-device
# solves, the ring of 256 at hops 2) on pivots of ~1e4, where the pivot row
# kept out of its own step matters: no element differs from the plain
# version, and β is as close to an f64 solve as torch.linalg.solve's
@pytest.mark.parametrize("what", ["S=1", "S=32", "S=256", "banded D=256 hops=2"])
def test_pivot_row_solves_are_bit_exact_and_near_f64_at_the_har_width(cuda, what):
    n, m = 128, 561
    s = 256 if what.startswith("banded") else int(what[2:])
    rng = np.random.default_rng(80 + s)
    u = _spd(rng, s, n, cuda) * 1e4
    v = torch.from_numpy(rng.standard_normal((s, n, m)).astype(np.float32)).to(cuda) * 1e4
    w = torch.cat([u, v], dim=2).contiguous()
    if what.startswith("banded"):
        p, b = _launched("banded_merge_solve", lambda: banded_merge_solve(w, 2, ridge=1e-3))
        rp, rb = banded_merge_solve_plain(w, 2, ridge=1e-3)
        acc = sum(torch.roll(w, -o, dims=0) for o in range(-2, 3))
    else:
        p, b = _launched("from_uv_solve", lambda: from_uv_solve(w[:, :, :n], w[:, :, n:],
                                                                ridge=1e-3))
        rp, rb = from_uv_solve_plain(u, v, ridge=1e-3)
        acc = w
    assert int((p != rp).sum()) == 0 and int((b != rb).sum()) == 0
    a = acc[:, :, :n] + 1e-3 * torch.eye(n, device=cuda)
    b64 = torch.linalg.solve(a.double(), acc[:, :, n:].double())
    lib = torch.linalg.solve(a, acc[:, :, n:])
    err, lib_err = _rel(b.double(), b64), _rel(lib.double(), b64)
    print(f"{what}: beta off an f64 solve {err:.3e}, torch.linalg.solve {lib_err:.3e}")
    assert err <= 4 * lib_err


# the wide layer: Ñ = 256 (Q = 8, V over 3 clusters) and 320 (Q = 10, V
# over 9), one system and 16; the same elimination, so no element differs
@pytest.mark.parametrize("s", [1, 16])
@pytest.mark.parametrize("n", [256, 320])
def test_from_uv_solve_is_bit_exact_on_a_wide_layer(cuda, s, n):
    rng = np.random.default_rng(30 + n + s)
    u = _spd(rng, s, n, cuda)
    v = torch.from_numpy(rng.standard_normal((s, n, 561)).astype(np.float32)).to(cuda)
    w = torch.cat([u, v], dim=2)
    p, b = _launched("from_uv_solve", lambda: from_uv_solve(w[:, :, :n], w[:, :, n:], ridge=1e-3))
    rp, rb = from_uv_solve_plain(u, v, ridge=1e-3)
    assert torch.isfinite(p).all() and torch.isfinite(b).all()
    assert int((p != rp).sum()) == 0 and int((b != rb).sum()) == 0


# past the cluster solve (the blocked wide solve, panels of 32 pivots in
# global memory): Ñ = 321 (a last panel of one pivot), 384 and 768 (the
# mnist_like width's widest bottleneck, m = 784), one system and three, and
# m = 0; the same elimination step for step, so no element differs
@pytest.mark.parametrize("s,n,m", [(1, 321, 561), (3, 321, 561), (1, 384, 561), (3, 384, 561),
                                   (1, 768, 784), (3, 768, 784), (1, 400, 0)])
def test_from_uv_solve_is_bit_exact_past_the_cluster_solve(cuda, s, n, m):
    rng = np.random.default_rng(60 + n + s)
    u = _spd(rng, s, n, cuda)
    v = torch.from_numpy(rng.standard_normal((s, n, m)).astype(np.float32)).to(cuda)
    w = torch.cat([u, v], dim=2)
    p, b = _launched("from_uv_solve", lambda: from_uv_solve(w[:, :, :n], w[:, :, n:], ridge=1e-3))
    rp, rb = from_uv_solve_plain(u, v, ridge=1e-3)
    assert torch.isfinite(p).all() and torch.isfinite(b).all()
    assert int((p != rp).sum()) == 0 and int((b != rb).sum()) == 0
    p2, b2 = from_uv_solve(w[:, :, :n], w[:, :, n:], ridge=1e-3)
    assert torch.equal(p, p2) and torch.equal(b, b2)


@pytest.mark.parametrize("hops", [1, 2])
def test_banded_merge_solve_kernel_matches_plain(cuda, hops):
    rng = np.random.default_rng(5 + hops)
    u = _spd(rng, D_ODD, 10, cuda)
    v = torch.from_numpy(rng.standard_normal((D_ODD, 10, 23)).astype(np.float32)).to(cuda)
    w = torch.cat([u, v], dim=2).contiguous()
    p, b = banded_merge_solve(w, hops, ridge=1e-3)
    rp, rb = banded_merge_solve_plain(w, hops, ridge=1e-3)
    assert _rel(p, rp) < 1e-5
    assert _rel(b, rb) < 1e-5
    with pytest.raises(ValueError, match="band"):
        banded_merge_solve(w[:4].contiguous(), 2, ridge=1e-3)


# the har width (Ñ = 128, m = 561) on a ring of 16, hops 1 and 2; m = 1000,
# where n + m passes the 1 024 slots one cluster holds, so the V columns
# split over two clusters; and the wide layer, Ñ = 256 and 320 on a ring of
# 8. The loader sums the band in the plain version's order and the
# elimination is from_uv_solve's: no element differs
@pytest.mark.parametrize("d,n,m,hops", [(16, 128, 561, 1), (16, 128, 561, 2), (5, 128, 1000, 2),
                                        (8, 256, 561, 1), (8, 256, 561, 2), (8, 320, 561, 1),
                                        (8, 320, 561, 2)])
def test_banded_merge_solve_is_bit_exact_with_plain(cuda, d, n, m, hops):
    rng = np.random.default_rng(9 + hops)
    u = _spd(rng, d, n, cuda)
    v = torch.from_numpy(rng.standard_normal((d, n, m)).astype(np.float32)).to(cuda)
    w = torch.cat([u, v], dim=2).contiguous()
    p, b = _launched("banded_merge_solve", lambda: banded_merge_solve(w, hops, ridge=1e-3))
    rp, rb = banded_merge_solve_plain(w, hops, ridge=1e-3)
    assert torch.isfinite(p).all() and torch.isfinite(b).all()
    assert int((p != rp).sum()) == 0 and int((b != rb).sum()) == 0


# the open ring past the cluster solve: each band summed as it loads, then
# the wide solve; no element differs
@pytest.mark.parametrize("d,n,m,hops", [(5, 321, 561, 1), (5, 384, 561, 2), (5, 768, 784, 2)])
def test_banded_merge_solve_is_bit_exact_past_the_cluster_solve(cuda, d, n, m, hops):
    rng = np.random.default_rng(70 + n + hops)
    u = _spd(rng, d, n, cuda)
    v = torch.from_numpy(rng.standard_normal((d, n, m)).astype(np.float32)).to(cuda)
    w = torch.cat([u, v], dim=2).contiguous()
    p, b = _launched("banded_merge_solve", lambda: banded_merge_solve(w, hops, ridge=1e-3))
    rp, rb = banded_merge_solve_plain(w, hops, ridge=1e-3)
    assert torch.isfinite(p).all() and torch.isfinite(b).all()
    assert int((p != rp).sum()) == 0 and int((b != rb).sum()) == 0


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """What the reference takes goes: an f64 window computes in f32, as the
    reference computes it with 64-bit floats off, and a strided payload is
    copied; an integer window still raises."""
    fleet = _fleet(cuda, "identity", 1.0)
    win = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (D_ODD, 3, F_ODD))).to(cuda)  # f64
    got, loss = _launched("fleet_ingest", lambda: fleet_ingest(fleet, win))
    ref, ref_loss = fleet_ingest_plain(fleet, win)
    assert _rel(got.p, ref.p) < 1e-4 and _rel(got.beta, ref.beta) < 1e-4
    assert _rel(loss, ref_loss) < 1e-4
    with pytest.raises(TypeError, match="floating-point"):
        fleet_ingest(fleet, win.to(torch.int32))
    rng = np.random.default_rng(5)
    w = torch.cat([_spd(rng, 5, 4, cuda), _randn(cuda, (5, 4, 5), seed=6)], 2)
    w = w.transpose(1, 2).contiguous().transpose(1, 2)  # (5, 4, 9), strided
    got = _launched("banded_merge_solve", lambda: banded_merge_solve(w, 1))
    want = banded_merge_solve_plain(w, 1)
    assert all(torch.equal(g, r) for g, r in zip(got, want))


# (256, 128, 561): the har width, tile 0 exactly U, a ragged last tile of
# 49 columns, 4 blocks a tile; (13, 10, 300): tiles across the U | V seam,
# odd everything, one block; the wide layer at (16, 256, 561) (8 blocks of
# 32 rows) and (16, 320, 561) (8 of 40, the seam inside tile 2); rows
# 16-byte aligned (16-byte loads): (16, 64, 300) and (7, 320, 564); and past
# the 512 rows 8 blocks hold in registers, each block's rest read twice:
# (4, 513, 300) (one row past), (3, 600, 564) (16-byte loads) and
# (2, 1024, 561)
@pytest.mark.parametrize("d,n,m", [(256, 128, 561), (13, 10, 300), (16, 256, 561),
                                   (16, 320, 561), (16, 64, 300), (7, 320, 564), (4, 513, 300),
                                   (3, 600, 564), (2, 1024, 561)])
@pytest.mark.parametrize("with_residual", [False, True])
def test_quantize_pack_kernel_matches_plain(cuda, d, n, m, with_residual):
    rng = np.random.default_rng(6)
    u = torch.from_numpy(rng.standard_normal((d, n, n)).astype(np.float32) * 10).to(cuda)
    v = torch.from_numpy(rng.standard_normal((d, n, m)).astype(np.float32) * 0.1).to(cuda)
    u[0] = 0.0
    v[0, :, : max(0, 128 - n)] = 0.0   # device 0: an all-zero first tile
    v[1, 2, 5] = float("nan")          # device 1: a diverged payload
    res = None
    if with_residual:
        res = torch.from_numpy(rng.standard_normal((d, n, n + m)).astype(np.float32) * 0.01)
        res[0, :, :128] = 0.0
        res = res.to(cuda)
    before = launch_counts()["quantize_pack"]
    got = quantize_pack(u, v, res)
    torch.cuda.synchronize()
    assert launch_counts()["quantize_pack"] == before + 1
    want = quantize_pack_plain(u, v, res)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
    # scale 1.0 on the all-zero tile and on the tile holding the NaN
    assert float(got[1][0, 0]) == 1.0 and float(got[1][1, (n + 5) // 128]) == 1.0


# (13, 10, 37): ragged clusters, one of them empty; (256, 128, 689): the
# har width on 32 clusters, as a hierarchical fleet merges; trims in
# registers (0–8) and past them (9: chains in shared memory), on the plan
# the wrapper picks (per-element at both shapes)
@pytest.mark.parametrize("d,r,c,n_clusters", [(13, 10, 37, 4), (256, 128, 689, 32)])
@pytest.mark.parametrize("trim", [0, 1, 2, 4, 5, 8, 9])
def test_robust_segment_sum_kernel_matches_plain(cuda, d, r, c, n_clusters, trim):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((d, r, c)).astype(np.float32)).to(cuda)
    if n_clusters == 4:
        cids = np.array([0] * 4 + [2] * 6 + [3] * 3, np.int32)
    else:
        cids = (np.arange(d) * n_clusters // d).astype(np.int32)
    mask = torch.from_numpy((rng.random(d) < 0.7).astype(np.float32)).to(cuda)
    scale = torch.from_numpy(rng.uniform(0.2, 1.0, d).astype(np.float32)).to(cuda)
    before = launch_counts()["robust_segment_sum_mix"]
    got = robust_segment_sum_mix(x, cids, mask, scale, n_clusters, trim)
    torch.cuda.synchronize()
    assert launch_counts()["robust_segment_sum_mix"] == before + 1
    want = robust_segment_sum_mix_plain(x, cids, mask, scale, n_clusters, trim)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# long chains: 128 threads a block (trim 100), 64 (300), 32 (500), and
# past what 32 threads' shared memory holds, a global workspace (1000);
# one star of 40 devices, so that a chain fills at trim 100 on neither side
@pytest.mark.parametrize("trim", [100, 300, 500, 1000])
def test_robust_segment_sum_kernel_with_long_chains(cuda, trim):
    rng = np.random.default_rng(trim)
    d = 40
    x = torch.from_numpy(rng.standard_normal((d, 6, 11)).astype(np.float32)).to(cuda)
    cids = np.zeros(d, np.int32)
    mask = torch.from_numpy((rng.random(d) < 0.8).astype(np.float32)).to(cuda)
    scale = torch.from_numpy(rng.uniform(0.2, 1.0, d).astype(np.float32)).to(cuda)
    got = _launched("robust_segment_sum_mix",
                    lambda: robust_segment_sum_mix(x, cids, mask, scale, 1, trim))
    for g, w in zip(got, robust_segment_sum_mix_plain(x, cids, mask, scale, 1, trim)):
        assert torch.equal(g, w)


# The robust sum's two plans (kernels/robust_merge.py::robust_streamed),
# each forced and as the wrapper picks it, one launch a call, bit for bit
# with the plain version: "star" one cluster of 4096 devices on (32, 80)
# payloads (the streamed plan's shape); "ragged" clusters of 1000 devices
# (three stages of 256 rows and one of 232), none, 200, 3 and 1 (shorter
# than 2·trim); "odd" a star of 700 on 3 × 853 elements (E % 4 ≠ 0: 4-byte
# copies, a last slice of 21 elements); "view" a star of 600 on (8, 16)
# payloads 4 bytes into their storage (4-byte copies); trims 0–9 across the
# register edge (the streamed plan takes up to 8 and refuses 9, which the
# rule never gives it).
ROBUST_CLUSTERS = {
    "star": (4096, (32, 80), [4096], 0),
    "ragged": (1204, (4, 20), [1000, 0, 200, 3, 1], 0),
    "odd": (700, (3, 853), [700], 0),
    "view": (600, (8, 16), [600], 1),
}


def _robust_case(cuda, name, seed):
    d, rc, runs, offset = ROBUST_CLUSTERS[name]
    cids = np.repeat(np.arange(len(runs), dtype=np.int32), runs)
    flat = _randn(cuda, (d * rc[0] * rc[1] + offset,), seed=seed)
    x = flat[offset:].view(d, *rc)
    rng = np.random.default_rng(seed + 1)
    mask = torch.from_numpy((rng.random(d) < 0.8).astype(np.float32)).to(cuda)
    scale = torch.from_numpy(rng.uniform(0.2, 1.0, d).astype(np.float32)).to(cuda)
    return x, cids, mask, scale, len(runs)


def _bits_equal(got, want):
    """tot, lo, hi equal bit for bit, NaN where the plain version has NaN
    (the card's NaN is canonical in both)."""
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        nan = torch.isnan(w)
        assert torch.equal(torch.isnan(g), nan)
        assert torch.equal(g.view(torch.int32)[~nan], w.view(torch.int32)[~nan])


def _on_plan(monkeypatch, plan, fn):
    """fn() with the wrapper's rule forced to ``plan`` ("element",
    "streamed") or as it is ("picked")."""
    from repro_torch.kernels import robust_merge

    if plan != "picked":
        monkeypatch.setattr(robust_merge, "robust_streamed", lambda *_: plan == "streamed")
    try:
        return _launched("robust_segment_sum_mix", fn)
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("name", sorted(ROBUST_CLUSTERS))
@pytest.mark.parametrize("trim", range(10))
def test_robust_segment_sum_plans_are_the_plain_version(cuda, monkeypatch, name, trim):
    from repro_torch.kernels.robust_merge import ROBUST_REG_TRIM

    x, cids, mask, scale, n_cl = _robust_case(cuda, name, seed=70 + trim)
    if name == "view":
        assert x.data_ptr() % 16 != 0
    args = (x, cids, mask, scale, n_cl, trim)
    want = robust_segment_sum_mix_plain(*args)
    plans = ("element", "streamed", "picked") if trim <= ROBUST_REG_TRIM else ("element",
                                                                                "picked")
    for plan in plans:
        _bits_equal(_on_plan(monkeypatch, plan, lambda: robust_segment_sum_mix(*args)), want)
    if n_cl > 1:
        assert not want[0][1].any() and not want[1][1].any() and not want[2][1].any()
    if trim > ROBUST_REG_TRIM:
        with pytest.raises(RuntimeError, match="robust_segment_sum_mix"):
            _on_plan(monkeypatch, "streamed", lambda: robust_segment_sum_mix(*args))


# ±0, ±inf and NaN at the streamed plan's split points: the rows where one
# sorter's group of four rows ends and the next one's starts (3 | 4,
# 35 | 36 | 39 | 40: sorters 0, 8 and 0 again), a stage's last and next
# rows (255 | 256) and the last row, live and masked, in columns of their
# own beside columns of many exact ties (-1, -0, +0, 1): a live NaN fills
# every register of its chains (lo and hi sum to 0), a masked one, or a
# masked inf (inf·0), reaches only tot.
SPLIT_ROWS = (3, 4, 35, 36, 39, 40, 255, 256, 259, 260, 599)


def _special_payload(cuda):
    d, e = 600, 64
    rng = np.random.default_rng(80)
    x = rng.standard_normal((d, e)).astype(np.float32)
    mask = np.ones(d, np.float32)
    mask[[4, 36, 256, 300]] = 0.0
    live = [r for r in SPLIT_ROWS if mask[r] > 0]
    x[list(SPLIT_ROWS), 1] = [0.0, -0.0] * 5 + [-0.0]                       # ±0
    x[live[::2], 2] = np.inf                                            # +inf, live
    x[live[1::2], 3] = -np.inf                                          # -inf, live
    x[[3, 255], 4] = np.inf
    x[[35, 599], 4] = -np.inf                                           # both infinities
    x[39, 5] = np.nan                                                   # NaN, live
    x[[4, 36], 6] = np.nan                                              # NaN, masked
    x[[256, 300], 7] = np.inf                                           # inf, masked
    x[:, 8:40] = rng.choice(np.float32([-1.0, -0.0, 0.0, 1.0]), (d, 32))  # ties
    x[:, 40] = -0.0
    x[:, 41] = np.nan
    scale = rng.uniform(0.2, 1.0, d).astype(np.float32)
    scale[list(SPLIT_ROWS[:4])] = 1.0
    return (torch.from_numpy(x.reshape(d, 4, 16)).to(cuda), np.zeros(d, np.int32),
            torch.from_numpy(mask).to(cuda), torch.from_numpy(scale).to(cuda), 1)


@pytest.mark.parametrize("trim", [1, 2, 5, 8, 9])
def test_robust_segment_sum_specials_at_the_chain_splits(cuda, monkeypatch, trim):
    x, cids, mask, scale, n_cl = _special_payload(cuda)
    args = (x, cids, mask, scale, n_cl, trim)
    want = robust_segment_sum_mix_plain(*args)
    tot, lo, hi = (w.reshape(-1) for w in want)
    assert torch.isnan(tot[[4, 5, 6, 7, 41]]).all() and not torch.isnan(tot[[0, 1, 2, 3, 40]]).any()
    assert not lo[[5, 41]].any() and not hi[[5, 41]].any()
    for plan in ("element", "streamed", "picked") if trim <= 8 else ("element",):
        _bits_equal(_on_plan(monkeypatch, plan, lambda: robust_segment_sum_mix(*args)), want)


def test_robust_segment_sum_shapes_take_both_plans(cuda):
    """The rule sends the star of 4096 on (32, 80) payloads to the streamed
    plan and the har width to the per-element one, on this card's SMs."""
    from repro_torch.kernels.robust_merge import robust_streamed

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert robust_streamed(1, 32 * 80, 4096, 1, sms)
    assert not robust_streamed(1, 128 * 689, 256, 1, sms)
    assert not robust_streamed(32, 128 * 689, 8, 1, sms)


# (13, 10, 37): everything odd; (256, 128, 689): the har width; then the
# 128 × 128 tile's edges: D past one row tile with F % 4 ≠ 0 (the scalar
# path), D short of two row tiles with F % 4 = 0, and one device
@pytest.mark.parametrize("d,r,c", [(13, 10, 37), (256, 128, 689), (130, 7, 9), (200, 16, 23),
                                   (1, 3, 5)])
def test_dense_mix_kernel_matches_plain(cuda, d, r, c):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((d, r, c)).astype(np.float32)).to(cuda)
    m = (rng.random((d, d)) < 0.3).astype(np.float32)
    m = np.maximum(np.maximum(m, m.T), np.eye(d, dtype=np.float32))
    before = launch_counts()["dense_mix"]
    got = dense_mix(x, m)
    torch.cuda.synchronize()
    assert launch_counts()["dense_mix"] == before + 1
    assert torch.equal(got, dense_mix_plain(x, m))


def test_dense_mix_kernel_on_a_misaligned_view(cuda):
    """x a contiguous view 4 bytes into its storage, F % 4 = 0: the 4-byte
    path, still bit for bit."""
    d, r, c = 40, 8, 16
    flat = _randn(cuda, (d * r * c + 1,), seed=23)
    x = flat[1:].view(d, r, c)
    m = (np.random.default_rng(24).random((d, d)) < 0.3).astype(np.float32)
    assert torch.equal(dense_mix(x, m), dense_mix_plain(x, m))


def _proj_err(x, a, b, act):
    """max |kernel − plain| of hidden_proj over the product's scale."""
    got = hidden_proj(x, a, b, activation=act)
    want = hidden_proj_plain(x, a, b, activation=act)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    pre = hidden_proj_plain(x, a, b, activation="identity")
    return float((got - want).abs().max() / max(want.abs().max(), pre.abs().max()))


def _randn(cuda, shape, dtype=torch.float32, seed=9):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device=cuda, dtype=dtype)


# (33, 257, 129): ragged everywhere; (1, 561, 128) and (3, 37, 19): the
# k=1 kernel (the k=1 step at the har width); (512, 561, 128): the E²LM
# batch statistics at the har width; then the split kernel's edges (slices
# of K from matmul_atb.split_plan): K shorter than one slice (one slice, the
# epilogue in the split kernel), K of two slices ending in a partial
# 16-column stage, 5 rows (one past the k=1 kernel's), 513 rows (one past a
# 32-row tile); and the k=1 kernel at K shorter than its 8 blocks and at 4 rows
@pytest.mark.parametrize("m,k,n", [(33, 257, 129), (1, 561, 128), (3, 37, 19), (512, 561, 128),
                                   (64, 40, 128), (64, 100, 128), (5, 561, 128), (513, 561, 129),
                                   (1, 5, 128), (4, 561, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hidden_proj_kernel_matches_plain(cuda, m, k, n, dtype):
    x, a = _randn(cuda, (m, k), dtype, 1), _randn(cuda, (k, n), dtype, 2)
    b = _randn(cuda, (n,), dtype, 3)
    before = launch_counts()["hidden_proj"]
    got = hidden_proj(x, a, b, activation="sigmoid")
    torch.cuda.synchronize()
    assert launch_counts()["hidden_proj"] == before + 1
    assert _proj_err(x, a, b, "sigmoid") <= 1e-6
    assert torch.equal(hidden_proj(x, a, b, activation="sigmoid"), got)  # a fixed order


@pytest.mark.parametrize("act", sorted(ACTIVATION_CODES))
@pytest.mark.parametrize("m", [1, 512])
def test_hidden_proj_kernel_applies_g_once_to_the_finished_sum(cuda, act, m):
    """G of the kernel's own identity output: the slices' sums are the same
    bits whatever the activation, so G applied per slice (or the bias added
    per slice) would show as a difference far above G's last bits."""
    x, a = _randn(cuda, (m, 561), seed=28), _randn(cuda, (561, 128), seed=29)
    b = _randn(cuda, (128,), seed=30)
    x = x * 0.05
    pre = hidden_proj(x, a, b, activation="identity")
    got = hidden_proj(x, a, b, activation=act)
    assert float((got - get_activation(act)(pre)).abs().max()) <= 1e-6 * max(
        1.0, float(pre.abs().max()))


@pytest.mark.parametrize("act", sorted(ACTIVATION_CODES))
@pytest.mark.parametrize("m", [1, 33])
def test_hidden_proj_kernel_every_activation(cuda, act, m):
    x, a = _randn(cuda, (m, 257), seed=4), _randn(cuda, (257, 129), seed=5)
    b = _randn(cuda, (129,), seed=6)
    assert _proj_err(x * 0.1, a, b, act) <= 1e-6


# (257, 33, 129): ragged; (128, 1, 128): the k=1 step's P·h; (512, 128, 128)
# and (512, 128, 561): U = HᵀH and V = HᵀX at the har width; then the split
# kernel's edges: K of one sample, of a partial 16-sample stage, of less than
# one slice, of one sample past a slice and of many slices; N1 = 5, the
# first shape past the skinny kernel's
@pytest.mark.parametrize("k,n1,n2", [(257, 33, 129), (128, 1, 128), (512, 128, 128),
                                     (512, 128, 561), (1, 128, 128), (17, 128, 561),
                                     (63, 128, 561), (513, 128, 561), (4097, 128, 561),
                                     (300, 5, 129)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_atb_kernel_matches_plain(cuda, k, n1, n2, dtype):
    a, b = _randn(cuda, (k, n1), dtype, 7), _randn(cuda, (k, n2), dtype, 8)
    before = launch_counts()["matmul_atb"]
    got = matmul_atb(a, b)
    torch.cuda.synchronize()
    assert launch_counts()["matmul_atb"] == before + 1
    assert _rel(got, matmul_atb_plain(a, b)) <= 1e-6
    assert torch.equal(matmul_atb(a, b), got)  # the slices are added in a fixed order


@pytest.mark.parametrize("k", [512, 4097])
def test_matmul_atb_kernel_on_a_batch_of_eight(cuda, k):
    """Eight devices' statistics side by side, as a fleet's Eq. 13 boot
    takes them: one launch, each product within 1e-6 of an f64 product's
    largest entry, and the same bits from a second call."""
    h, x = _randn(cuda, (8, k, 128), seed=18), _randn(cuda, (8, k, 561), seed=19)
    before = launch_counts()["matmul_atb"]
    got = matmul_atb(h, x)
    torch.cuda.synchronize()
    assert launch_counts()["matmul_atb"] == before + 1
    assert _rel(got, (h.double().transpose(1, 2) @ x.double()).float()) <= 1e-6
    assert torch.equal(matmul_atb(h, x), got)


def test_matmul_atb_kernel_batches_and_refuses(cuda):
    """f64 operands compute in f32 and a strided one is copied, each equal
    to the plain version at the kernel's bound; an integer one raises."""
    a, b = _randn(cuda, (3, 50, 12), seed=10), _randn(cuda, (3, 50, 20), seed=11)
    assert _rel(matmul_atb(a, b), matmul_atb_plain(a, b)) <= 1e-6
    got = _launched("matmul_atb", lambda: matmul_atb(a.double(), b.double()))
    assert got.dtype == torch.float32
    assert _rel(got, matmul_atb_plain(a.double(), b.double())) <= 1e-6
    strided = a.transpose(1, 2).contiguous().transpose(1, 2)
    assert _rel(matmul_atb(strided, b), matmul_atb_plain(strided, b)) <= 1e-6
    with pytest.raises(TypeError, match="floating-point"):
        matmul_atb(a.to(torch.int32), b)


# (128, 128): P; (128, 561): β, its rows crossing 16-byte vectors;
# (33, 257): ragged; (5, 3) and (1, 7): rows shorter than a vector and one
# row
@pytest.mark.parametrize("n1,n2", [(128, 128), (128, 561), (33, 257), (5, 3), (1, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rank1_add_kernel_is_bit_exact_with_plain(cuda, n1, n2, dtype):
    x = _randn(cuda, (n1, n2), dtype, 12)
    u, v = _randn(cuda, (n1,), dtype, 13), _randn(cuda, (n2,), dtype, 14)
    scale = torch.tensor(-1.0, device=cuda) / torch.tensor(2.7, device=cuda)  # on the card
    before = launch_counts()["rank1_add"]
    got = rank1_add(x, u, v, scale)
    torch.cuda.synchronize()
    assert launch_counts()["rank1_add"] == before + 1
    assert torch.equal(got, rank1_add_plain(x, u, v, scale))
    assert torch.equal(rank1_add(x, u, v, 0.37), rank1_add_plain(x, u, v, 0.37))


def test_rank1_add_kernel_on_a_misaligned_view(cuda):
    """A contiguous view 4 bytes into its storage takes the scalar path."""
    flat = _randn(cuda, (128 * 128 + 1,), seed=15)
    x = flat[1:].view(128, 128)
    u, v = _randn(cuda, (128,), seed=16), _randn(cuda, (128,), seed=17)
    assert torch.equal(rank1_add(x, u, v, -0.5), rank1_add_plain(x, u, v, -0.5))


# the k=1 step's tail in one launch: the har width (Ñ = 128, m = 561), odd
# widths, Ñ past the 256 rows a β strip keeps in shared memory, one row
@pytest.mark.parametrize("n,m", [(128, 561), (37, 23), (300, 561), (1, 5), (129, 64)])
def test_k1_update_kernel_is_bit_exact_with_plain(cuda, n, m):
    rng = np.random.default_rng(n + m)
    p = _spd(rng, 1, n, cuda)[0]
    beta, h, ph, t = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
                      for shape in ((n, m), (n,), (n,), (m,)))
    got = _launched("rank1_add", lambda: k1_update(p, beta, h, ph, t))
    want = k1_update_plain(p, beta, h, ph, t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("activation,forget", [("identity", 1.0), ("sigmoid", 0.97)])
def test_k1_step_and_batch_statistics_on_the_kernels(cuda, activation, forget):
    """One k=1 step at the har width launches hidden_proj, matmul_atb and
    the k=1 tail (counted as rank1_add) once each and agrees with the plain
    composition; the batch statistics launch hidden_proj once and
    matmul_atb twice."""
    state = _fleet(cuda, activation, forget, d=1, n=561, nh=128)
    state = state.replace(beta=state.beta[0], p=state.p[0])
    x = torch.rand(561, generator=torch.Generator().manual_seed(0)).to(cuda)
    before = launch_counts()
    got = oselm_step_k1_kernel(state, x, x)
    torch.cuda.synchronize()
    after = launch_counts()
    assert [after[k] - before[k] for k in ("hidden_proj", "matmul_atb", "rank1_add")] == [1, 1, 1]
    want = oselm_step_k1_plain(state, x, x)
    assert _rel(got.p, want.p) <= 1e-5 and _rel(got.beta, want.beta) <= 1e-5
    xs = torch.rand((512, 561), generator=torch.Generator().manual_seed(1)).to(cuda)
    before = launch_counts()
    alpha, bias = state.params
    u, v = uv_from_batch_kernel(alpha, bias, xs, xs, activation=activation)
    torch.cuda.synchronize()
    after = launch_counts()
    assert [after[k] - before[k] for k in ("hidden_proj", "matmul_atb")] == [1, 2]
    ru, rv = uv_from_batch_plain(alpha, bias, xs, xs, activation=activation)
    assert _rel(u, ru) <= 1e-6 and _rel(v, rv) <= 1e-6


def _launched(name, fn):
    before = launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1, name
    return out


# (13, 10, 37, 4): ragged clusters, one of them empty; (256, 128, 689, 32)
# and (256, 128, 689, 1): the har width as a hierarchical fleet and a star
# merge
@pytest.mark.parametrize("d,r,c,n_clusters", [(13, 10, 37, 4), (256, 128, 689, 32),
                                              (256, 128, 689, 1)])
def test_segment_sum_kernel_is_bit_exact_with_plain(cuda, d, r, c, n_clusters):
    rng = np.random.default_rng(20)
    w = torch.from_numpy(rng.standard_normal((d, r, c)).astype(np.float32)).to(cuda)
    if n_clusters == 4:
        cids = np.array([0] * 4 + [2] * 6 + [3] * 3, np.int32)
    else:
        cids = (np.arange(d) * n_clusters // d).astype(np.int32)
    got = _launched("segment_sum_mix", lambda: segment_sum_mix(w, cids, n_clusters))
    assert torch.equal(got, segment_sum_mix_plain(w, cids, n_clusters))
    if n_clusters == 4:
        assert not got[1].any()
    if n_clusters > 1:
        with pytest.raises(ValueError, match="sorted"):
            segment_sum_mix(w, cids[::-1].copy(), n_clusters)


# (13, 10, 37): 370 elements a row, the one-element path; (13, 8, 36) and
# the har width (C = 32 → 256, 88 192 a row): the 16-byte path
@pytest.mark.parametrize("d,r,c,n_clusters", [(13, 10, 37, 4), (13, 8, 36, 3),
                                              (256, 128, 689, 32)])
def test_segment_broadcast_kernel_is_bit_exact_with_plain(cuda, d, r, c, n_clusters):
    rng = np.random.default_rng(21)
    sums = torch.from_numpy(rng.standard_normal((n_clusters, r, c)).astype(np.float32)).to(cuda)
    cids = np.sort(rng.integers(0, n_clusters, d)).astype(np.int32)
    got = _launched("segment_broadcast", lambda: segment_broadcast(sums, cids))
    assert got.shape == (d, r, c)
    assert torch.equal(got, segment_broadcast_plain(sums, cids))


def test_segment_broadcast_kernel_on_a_misaligned_view(cuda):
    """Rows of 4k floats that start 4 bytes into their storage take the
    one-element path."""
    flat = _randn(cuda, (3 * 8 * 36 + 1,), seed=22)
    sums = flat[1:].view(3, 8, 36)
    cids = np.array([0, 0, 1, 2, 2, 2, 1], np.int32)
    assert torch.equal(segment_broadcast(sums, cids), segment_broadcast_plain(sums, cids))


# (13, 10, 37): one element a thread, hops 0, 1, 2 and 6 (2·hops+1 = D, the
# shared-memory ring); the har width at hops 2 (on an H100, 7 runs of 37
# devices, the last of 34); (37, 256, 844): four elements a thread, 211
# blocks a run of devices, so that a run is long (13 devices at hops 2 on
# an H100, the last of 11, or the whole ring), its band wraps past device
# 36, at hops 2, 4 (the widest register window), 5 and 7 (the
# shared-memory ring); (61, 8, 100) at hops 30: a ring too wide for 256
# threads a block; past the widest ring one block holds (hops 226), the
# band read from global memory: hops 227 on 455 devices (2·hops + 1 = D,
# four elements a thread) and on 460 (one element a thread)
@pytest.mark.parametrize("d,r,c,hops", [(13, 10, 37, 0), (13, 10, 37, 1), (13, 10, 37, 2),
                                        (13, 10, 37, 6), (256, 128, 689, 2), (37, 256, 844, 2),
                                        (37, 256, 844, 4), (37, 256, 844, 5), (37, 256, 844, 7),
                                        (61, 8, 100, 30), (455, 4, 8, 227), (460, 3, 7, 227)])
def test_banded_mix_kernel_is_bit_exact_with_plain(cuda, d, r, c, hops):
    x = torch.from_numpy(
        np.random.default_rng(23).standard_normal((d, r, c)).astype(np.float32)).to(cuda)
    got = _launched("banded_mix", lambda: banded_mix(x, hops))
    assert torch.equal(got, banded_mix_plain(x, hops))


@pytest.mark.parametrize("hops", [2, 5])
def test_banded_mix_kernel_on_a_misaligned_view(cuda, hops):
    """Rows of 4k floats that start 4 bytes into their storage take the
    one-element path, in registers and in the shared-memory ring."""
    d, r, c = 37, 64, 200
    flat = _randn(cuda, (d * r * c + 1,), seed=25)
    x = flat[1:].view(d, r, c)
    got = _launched("banded_mix", lambda: banded_mix(x, hops))
    assert torch.equal(got, banded_mix_plain(x, hops))


# the fleet-scale benchmarks' shapes (benchmarks/torch_fleet_scale.py's
# merge bench and benchmarks/torch_fleet_ingest.py): D = 4096 fleets of
# (32, 80) payloads as a star (C = 1) and a hierarchy (C = D/8), the ring's
# hops 2, 4096 systems at Ñ = 32, m = 48, and the ingest at Ñ = 32,
# n = m = 64, T = 32
@pytest.mark.parametrize("n_clusters", [1, 512])
def test_segment_sum_kernel_at_fleet_scale(cuda, n_clusters):
    w = _randn(cuda, (4096, 32, 80), seed=40)
    cids = (np.arange(4096) * n_clusters // 4096).astype(np.int32)
    got = _launched("segment_sum_mix", lambda: segment_sum_mix(w, cids, n_clusters))
    assert torch.equal(got, segment_sum_mix_plain(w, cids, n_clusters))


def test_banded_mix_kernel_at_fleet_scale(cuda):
    w = _randn(cuda, (4096, 32, 80), seed=41)
    got = _launched("banded_mix", lambda: banded_mix(w, 2))
    assert torch.equal(got, banded_mix_plain(w, 2))


def test_from_uv_solve_is_bit_exact_at_fleet_scale(cuda):
    rng = np.random.default_rng(42)
    u = _spd(rng, 4096, 32, cuda)
    v = torch.from_numpy(rng.standard_normal((4096, 32, 48)).astype(np.float32)).to(cuda)
    p, b = _launched("from_uv_solve", lambda: from_uv_solve(u, v))
    rp, rb = from_uv_solve_plain(u, v)
    assert torch.isfinite(p).all() and torch.isfinite(b).all()
    assert int((p != rp).sum()) == 0 and int((b != rb).sum()) == 0


def test_ingest_kernel_at_fleet_scale(cuda):
    rng = np.random.default_rng(43)
    params = SLFNParams(
        torch.from_numpy(rng.uniform(-1, 1, (64, 32)).astype(np.float32)).to(cuda),
        torch.from_numpy(rng.uniform(-1, 1, 32).astype(np.float32)).to(cuda),
    )
    x0 = torch.from_numpy(rng.uniform(0, 1, (4096, 64, 64)).astype(np.float32)).to(cuda)
    fleet = init_oselm(params, x0, x0, activation="identity", ridge=1e-3)
    win = torch.from_numpy(rng.uniform(0, 1, (4096, 32, 64)).astype(np.float32)).to(cuda)
    got, loss = _launched("fleet_ingest", lambda: fleet_ingest(fleet, win))
    ref, ref_loss = fleet_ingest_plain(fleet, win)
    assert _rel(got.p, ref.p) < 1e-4
    assert _rel(got.beta, ref.beta) < 1e-4
    assert _rel(loss, ref_loss) < 1e-4


def test_segment_offsets_go_to_the_card_once(cuda):
    """A second segment sum over the same clusters reads the offsets the
    first one copied (a copy from pageable memory at every call waits for
    the stream)."""
    w = _randn(cuda, (1024, 32, 80), seed=44)
    cids = (np.arange(1024) * 128 // 1024).astype(np.int32)
    segment_sum_mix(w, cids, 128)
    hits = _starts_on.cache_info().hits
    got = _launched("segment_sum_mix", lambda: segment_sum_mix(w, cids.copy(), 128))
    assert _starts_on.cache_info().hits == hits + 1
    assert torch.equal(got, segment_sum_mix_plain(w, cids, 128))


# the two plans of the segment sums (kernels/topology_merge.py::
# segsum_streamed), both instances, 0 elements differing: D = 4096 on
# (32, 80) payloads as a star (C = 1, streamed), in three uneven clusters
# with one of a single device (streamed) and in 512 (per-element); odd
# payloads of 1, 3 and 2559 elements (streamed, 4-byte copies); D = 1024 as
# a star; the har width, 88 192 elements, as a star (per-element)
SEGSUM_CLUSTERS = {
    "star": lambda d: np.zeros(d, np.int32),
    "uneven": lambda d: np.repeat(np.arange(3, dtype=np.int32), [d - d // 4 - 1, 1, d // 4]),
    "c512": lambda d: (np.arange(d) * 512 // d).astype(np.int32),
}
SEGSUM_SHAPES = [
    (4096, (32, 80), "star"), (4096, (32, 80), "uneven"), (4096, (32, 80), "c512"),
    (4096, (1, 1), "star"), (4096, (1, 3), "star"), (4096, (3, 853), "star"),
    (1024, (32, 80), "star"), (256, (128, 689), "star"),
]


def _segsum_case(cuda, d, rc, clusters, seed, offset=0):
    cids = SEGSUM_CLUSTERS[clusters](d)
    n_cl = int(cids.max()) + 1
    e = rc[0] * rc[1]
    flat = _randn(cuda, (d * e + offset,), seed=seed)
    w = flat[offset:].view(d, *rc)  # offset 1: a view off a 16-byte boundary
    gen = np.random.default_rng(seed + 1)
    mask = torch.from_numpy((gen.random(d) < 0.8).astype(np.float32)).to(cuda)
    assert (mask == 0).any()
    return w, cids, n_cl, mask


def _segsum_holds(w, cids, n_cl, mask):
    got = _launched("segment_sum_mix", lambda: segment_sum_mix(w, cids, n_cl))
    assert _differ(got, segment_sum_mix_plain(w, cids, n_cl)) == 0
    got = _launched("masked_segment_sum_mix",
                    lambda: masked_segment_sum_mix(w, cids, mask, n_cl))
    assert _differ(got, masked_segment_sum_mix_plain(w, cids, mask, n_cl)) == 0


def _differ(got, want):
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    return int((got != want).sum())


@pytest.mark.parametrize("d,rc,clusters", SEGSUM_SHAPES)
def test_segment_sums_on_either_plan_are_the_plain_versions(cuda, d, rc, clusters):
    _segsum_holds(*_segsum_case(cuda, d, rc, clusters, seed=50))


@pytest.mark.parametrize("d,rc,clusters", [(4096, (32, 80), "star"), (4096, (32, 80), "uneven"),
                                           (256, (128, 689), "star")])
def test_segment_sums_on_a_misaligned_view(cuda, d, rc, clusters):
    w, *rest = _segsum_case(cuda, d, rc, clusters, seed=51, offset=1)
    assert w.data_ptr() % 16 != 0
    _segsum_holds(w, *rest)


def test_segment_sum_shapes_take_both_plans(cuda):
    from repro_torch.kernels.topology_merge import segsum_streamed

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plans = set()
    for d, (r, c), clusters in SEGSUM_SHAPES:
        cids = SEGSUM_CLUSTERS[clusters](d)
        plans.add(segsum_streamed(int(cids.max()) + 1, r * c, int(np.bincount(cids).max()),
                                  sms))
    assert plans == {True, False}


def _mixed(*tensors):
    """The operands as a caller may pass them: every other one bf16 (a lone
    one too), the first one strided."""
    out = [t.bfloat16() if i % 2 or len(tensors) == 1 else t for i, t in enumerate(tensors)]
    out[0] = out[0].transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not out[0].is_contiguous()
    return out


def _mixed_cases(cuda):
    """name → (kernel, plain, operands, bound: 0 for bit for bit, else the
    kernel's bound against its plain version on its own test's measure)."""
    r = functools.partial(_randn, cuda)
    rng = np.random.default_rng(60)
    cids = np.array([0, 0, 0, 1, 2, 2], np.int32)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0, 0.0], device=cuda)
    fleet = _fleet(cuda, "identity", 0.95)
    return {
        "hidden_proj": (lambda x, a, b: hidden_proj(x, a, b, activation="identity"),
                        lambda x, a, b: hidden_proj_plain(x, a, b, activation="identity"),
                        (r((33, 257), seed=1), r((257, 129), seed=2), r((129,), seed=3)), 1e-6),
        "matmul_atb": (matmul_atb, matmul_atb_plain, (r((257, 33), seed=4), r((257, 129), seed=5)),
                       1e-6),
        "rank1_add": (lambda x, u, v: rank1_add(x, u, v, 0.37),
                      lambda x, u, v: rank1_add_plain(x, u, v, 0.37),
                      (r((33, 257), seed=6), r((33,), seed=7), r((257,), seed=8)), 0),
        "k1_update": (k1_update, k1_update_plain,
                      (r((37, 37), seed=9), r((37, 23), seed=10), r((37,), seed=11),
                       r((37,), seed=12), r((23,), seed=13)), 0),
        "flash_attention": (flash_attention, flash_attention_plain,
                            tuple(r((2, 77, 3, 64), seed=14 + i) for i in range(3)), 1e-5),
        "gla_forward": (gla_forward, gla_forward_plain,
                        (r((2, 200, 3, 16), seed=17), r((2, 200, 3, 16), seed=18),
                         r((2, 200, 3, 64), seed=19), -r((2, 200, 3), seed=20).abs() * 0.1), 1e-5),
        "fleet_ingest": (lambda win: fleet_ingest(fleet, win),
                         lambda win: fleet_ingest_plain(fleet, win),
                         (r((D_ODD, T_ODD, F_ODD), seed=21),), 1e-4),
        "quantize_pack": (quantize_pack, quantize_pack_plain,
                          (r((13, 10, 10), seed=22), r((13, 10, 27), seed=23),
                           r((13, 10, 37), seed=24) * 0.01), 0),
        "banded_mix": (lambda x: banded_mix(x, 2), lambda x: banded_mix_plain(x, 2),
                       (r((13, 10, 37), seed=25),), 0),
        "banded_merge_solve": (
            lambda w: banded_merge_solve(w, 1, ridge=1e-3),
            lambda w: banded_merge_solve_plain(w, 1, ridge=1e-3),
            (torch.cat([_spd(rng, 5, 10, cuda), r((5, 10, 27), seed=26)], 2),), 0),
        "dense_mix": (lambda x: dense_mix(x, np.ones((13, 13), np.float32)),
                      lambda x: dense_mix_plain(x, np.ones((13, 13), np.float32)),
                      (r((13, 10, 37), seed=27),), 0),
        "from_uv_solve": (lambda u, v: from_uv_solve(u, v, ridge=1e-3),
                          lambda u, v: from_uv_solve_plain(u, v, ridge=1e-3),
                          (_spd(rng, 3, 10, cuda), r((3, 10, 27), seed=28)), 0),
        "segment_sum_mix": (lambda w: segment_sum_mix(w, cids, 3),
                            lambda w: segment_sum_mix_plain(w, cids, 3), (r((6, 10, 37), seed=29),),
                            0),
        "masked_segment_sum_mix": (
            lambda w, m: masked_segment_sum_mix(w, cids, m, 3),
            lambda w, m: masked_segment_sum_mix_plain(w, cids, m, 3),
            (r((6, 10, 37), seed=30), mask), 0),
        "segment_broadcast": (lambda s: segment_broadcast(s, cids),
                              lambda s: segment_broadcast_plain(s, cids),
                              (r((3, 10, 37), seed=31),), 0),
        "robust_segment_sum_mix": (
            lambda x, m, sc: robust_segment_sum_mix(x, cids, m, sc, 3, 1),
            lambda x, m, sc: robust_segment_sum_mix_plain(x, cids, m, sc, 3, 1),
            (r((6, 10, 37), seed=32), mask, torch.full((6,), 0.5, device=cuda)), 0),
    }


MIXED_NAMES = ["hidden_proj", "matmul_atb", "rank1_add", "k1_update", "flash_attention",
               "gla_forward", "fleet_ingest", "quantize_pack", "banded_mix", "banded_merge_solve",
               "dense_mix", "from_uv_solve", "segment_sum_mix", "masked_segment_sum_mix",
               "segment_broadcast", "robust_segment_sum_mix"]


@pytest.mark.parametrize("name", MIXED_NAMES)
def test_wrappers_take_strided_and_mixed_operands(cuda, name):
    """Every wrapper takes what the reference and its plain version take: a
    strided operand and a bf16 one beside f32 (computed in f32), launching
    its kernel once and equal to the plain version on the same operands at
    the kernel's bound (0: bit for bit)."""
    kernel, plain, args, tol = _mixed_cases(cuda)[name]
    args = _mixed(*args)
    counted = "rank1_add" if name == "k1_update" else name
    got = _launched(counted, lambda: kernel(*args))
    want = plain(*args)
    if name == "fleet_ingest":
        got, want = (got[0].p, got[0].beta, got[1]), (want[0].p, want[0].beta, want[1])
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        if tol == 0:
            assert int(((g != w) & ~(torch.isnan(g) & torch.isnan(w))).sum()) == 0
        elif name in ("flash_attention", "gla_forward"):
            assert _row_rel(g, w) <= tol
        else:
            assert _rel(g, w) <= tol


def test_mix_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """Bands wider than the ring and ids out of range still raise; strided
    and f64 payloads go, each bit for bit with the plain version."""
    x = _randn(cuda, (5, 4, 9), seed=12)
    with pytest.raises(ValueError, match="band"):
        banded_mix(x, 3)
    with pytest.raises(ValueError, match="band"):
        banded_mix(torch.zeros((454, 1, 4), device=cuda), 227)
    xt = x.transpose(1, 2)
    assert torch.equal(_launched("banded_mix", lambda: banded_mix(xt, 1)), banded_mix_plain(xt, 1))
    zeros = np.zeros(5, np.int32)
    got = _launched("segment_sum_mix", lambda: segment_sum_mix(x.double(), zeros, 1))
    assert torch.equal(got, segment_sum_mix_plain(x.double(), zeros, 1))
    got = _launched("segment_broadcast", lambda: segment_broadcast(xt, zeros))
    assert torch.equal(got, segment_broadcast_plain(xt, zeros))
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        segment_broadcast(x, np.arange(6, dtype=np.int32))


@pytest.mark.parametrize("name", ["star", "hierarchical", "hierarchical_isolated",
                                  "all_to_all", "ring2", "ring_closed", "custom"])
def test_topology_mix_on_the_card_is_the_cpu_mix(cuda, name):
    """The card's mix launches its route's kernel and agrees with the CPU's
    plain mix: bit for bit through the segment and band kernels, at f32
    rounding where a head exchange or a closed band sums with PyTorch."""
    d = 13
    mask = (np.random.default_rng(24).random((d, d)) < 0.35).astype(np.float32)
    topo = {
        "star": star(d), "hierarchical": hierarchical(d, 3),
        "hierarchical_isolated": hierarchical(d, 3, head_exchange=False),
        "all_to_all": all_to_all(d), "ring2": ring(d, 2), "ring_closed": ring(d, 6),
        "custom": Topology(name="custom", n_devices=d, kind="dense",
                           matrix=np.maximum(np.maximum(mask, mask.T), np.eye(d, dtype=np.float32))),
    }[name]
    x = np.random.default_rng(25).standard_normal((d, 10, 37)).astype(np.float32)
    before = launch_counts()
    got = topology_mix(torch.from_numpy(x).to(cuda), topo)
    torch.cuda.synchronize()
    after = launch_counts()
    launched = {k for k in after if after[k] != before[k]}
    want = topology_mix(torch.from_numpy(x), topo)
    routes = {"star": {"segment_sum_mix"}, "hierarchical": {"segment_sum_mix"},
              "hierarchical_isolated": {"segment_sum_mix", "segment_broadcast"},
              "all_to_all": {"dense_mix"}, "ring2": {"banded_mix"}, "ring_closed": set(),
              "custom": {"dense_mix"}}
    assert launched == routes[name]
    if name in ("hierarchical_isolated", "ring2", "all_to_all", "custom"):
        assert torch.equal(got.cpu(), want)
    else:
        assert _rel(got.cpu(), want) <= 1e-6


def _draw(cuda, shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=cuda).to(dtype)


# odd lengths and tails, non-causal, every head width the kernel takes,
# fewer queries than keys (cross attention) and the hymba serving shape; then
# the tensor-core kernel's edges: one query, a 64-row block one short and one
# over, a long odd prompt, B·H = 100 at hd = 128, fewer queries than keys at
# hd = 128
@pytest.mark.parametrize("b,sq,sk,h,hd,causal", [
    (2, 33, 33, 3, 64, True), (2, 200, 200, 3, 64, False), (1, 96, 96, 2, 128, True),
    (1, 130, 130, 2, 256, True), (1, 77, 77, 2, 256, False), (2, 100, 100, 2, 128, False),
    (2, 24, 150, 3, 64, False), (4, 512, 512, 25, 64, True), (4, 2048, 2048, 25, 64, True),
    (1, 1, 1, 2, 64, True), (1, 63, 63, 2, 64, True), (1, 65, 65, 2, 64, True),
    (2, 1000, 1000, 3, 64, True), (4, 300, 300, 25, 128, True), (2, 70, 300, 2, 128, False),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, b, sq, sk, h, hd, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(sq + hd)
    q = _draw(cuda, (b, sq, h, hd), dtype, gen)
    k, v = (_draw(cuda, (b, sk, h, hd), dtype, gen) for _ in range(2))
    got = _launched("flash_attention", lambda: flash_attention(q, k, v, causal=causal))
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    assert _row_rel(got, want) <= (1e-5 if dtype == torch.float32 else 2e-2)


# each chunk is a block of its own and one pass carries the state through
# the chunks in order: 32 chunks (S = 4096), 24 with a partial last one of
# 57 tokens (S = 3001), one short chunk (S = 77), and a second chunk of one
# token under four 64-column passes (dv = 200)
@pytest.mark.parametrize("b,s,h,dk,dv", [(2, 33, 3, 16, 8), (2, 200, 3, 16, 64),
                                         (4, 1000, 25, 16, 64), (4, 2048, 25, 16, 64),
                                         (1, 300, 2, 64, 65),
                                         (1, 1, 2, 16, 64), (1, 4096, 2, 16, 64),
                                         (1, 3001, 2, 16, 64), (2, 77, 3, 16, 64),
                                         (1, 129, 2, 16, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gla_kernel_matches_plain(cuda, b, s, h, dk, dv, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s + dv)
    q, k = (_draw(cuda, (b, s, h, dk), dtype, gen) for _ in range(2))
    v = _draw(cuda, (b, s, h, dv), dtype, gen)
    log_a = -torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=cuda))
    y, state = _launched("gla_forward", lambda: gla_forward(q, k, v, log_a))
    want_y, want_state = gla_forward_plain(q, k, v, log_a)
    assert y.dtype == dtype and state.dtype == torch.float32
    assert _row_rel(y, want_y) <= (1e-5 if dtype == torch.float32 else 2 ** -8)
    assert _row_rel(state, want_state) <= 1e-5


# more (batch, head) pairs than a grid's y axis takes (65 535): B·H is on x
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_past_65535_heads(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (_draw(cuda, (65_600, 16, 1, 64), dtype, gen) for _ in range(3))
    got = _launched("flash_attention", lambda: flash_attention(q, k, v, causal=True))
    want = flash_attention_plain(q, k, v, causal=True)
    assert _row_rel(got, want) <= (1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gla_kernel_on_a_misaligned_view(cuda, dtype):
    """Widths that take 16-byte loads, on views one element into their
    storage: the kernels read element by element instead."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    b, s, h, dk, dv = 1, 300, 2, 16, 64

    def view(shape):
        flat = _draw(cuda, (int(np.prod(shape)) + 1,), dtype, gen)
        return flat[1:].view(shape)

    q, k, v = view((b, s, h, dk)), view((b, s, h, dk)), view((b, s, h, dv))
    log_a = -torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=cuda))
    y, state = _launched("gla_forward", lambda: gla_forward(q, k, v, log_a))
    want_y, want_state = gla_forward_plain(q, k, v, log_a)
    assert _row_rel(y, want_y) <= (1e-5 if dtype == torch.float32 else 2 ** -8)
    assert _row_rel(state, want_state) <= 1e-5


def test_attention_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """f16, bf16/f32 and f16/f32 mixes and strided operands go, each against
    the plain version. These compute in f32 on the card with p rounded to
    v's type before p·v, as the plain version and the reference round it:
    an f32 output is held at the f32 bound (1e-5 of the row), a narrower one
    at one step of its type (the two f32 results, 1e-7 apart, may round to
    neighbours). Mismatched shapes and an integer operand still raise."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = _draw(cuda, (1, 8, 2, 64), torch.float32, gen)
    k, v = (_draw(cuda, (1, 8, 2, 64), torch.float32, gen) for _ in range(2))
    for ops, bound in [((q.half(), k.half(), v.half()), 2 ** -10),
                       ((q, k.half(), v.half()), 1e-5),
                       ((q, k.bfloat16(), v.bfloat16()), 1e-5),
                       ((q.bfloat16(), k, v), 2 ** -8)]:
        got = _launched("flash_attention", lambda: flash_attention(*ops))
        want = flash_attention_plain(*ops)
        assert got.dtype == want.dtype == ops[0].dtype and _row_rel(got, want) <= bound
    strided = [t.transpose(1, 2) for t in (q, k, v)]
    got = _launched("flash_attention", lambda: flash_attention(*strided))
    assert _row_rel(got, flash_attention_plain(*strided)) <= 1e-5
    with pytest.raises(ValueError, match="differ"):
        flash_attention(q, q[..., :32].contiguous(), q[..., :32].contiguous())
    with pytest.raises(TypeError, match="floating-point"):
        flash_attention(q, k.to(torch.int32), v)
    log_a = -torch.rand((1, 8, 2), generator=gen, device=cuda)
    args = (q[..., :16], k[..., :16], v, log_a)  # q and k strided slices
    y, state = _launched("gla_forward", lambda: gla_forward(*args))
    want_y, want_state = gla_forward_plain(*args)
    assert _row_rel(y, want_y) <= 1e-5 and _row_rel(state, want_state) <= 1e-5
    with pytest.raises(ValueError, match="log_a"):
        gla_forward(q, q, q, torch.zeros(1, 8, 3, device=cuda))


# every head width the reference takes: under 64, between the instances
# (100: hd·2 bytes not a multiple of 16, so bf16 loads element by element)
# and past 256 (the slice-streaming kernel); one query, a short odd prompt
# and the serving length
@pytest.mark.parametrize("hd", [16, 32, 80, 96, 100, 320, 512])
@pytest.mark.parametrize("s", [1, 77, 512])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_any_head_width(cuda, hd, s, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s + hd)
    q, k, v = (_draw(cuda, (2, s, 3, hd), dtype, gen) for _ in range(3))
    got = _launched("flash_attention", lambda: flash_attention(q, k, v, causal=causal))
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    assert _row_rel(got, want) <= (1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("hd", [64, 80, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_on_a_misaligned_view(cuda, hd, dtype):
    """Contiguous views one element into their storage (2 bytes for bf16,
    off the tensor-core kernel's 16-byte copies): element loads instead."""
    gen = torch.Generator(device=cuda).manual_seed(hd)
    shape = (2, 150, 3, hd)

    def view():
        flat = _draw(cuda, (int(np.prod(shape)) + 1,), dtype, gen)
        return flat[1:].view(shape)

    q, k, v = view(), view(), view()
    got = _launched("flash_attention", lambda: flash_attention(q, k, v, causal=True))
    want = flash_attention_plain(q, k, v, causal=True)
    assert _row_rel(got, want) <= (1e-5 if dtype == torch.float32 else 2e-2)


# dk × dv past one block's shared memory (the tiled wide path), from the
# first widths it takes to xLSTM's mLSTM (512 × 513) and a wide v; one
# token, a second chunk of one token, four chunks
GLA_WIDE = [(128, 64), (96, 96), (128, 128), (256, 256), (512, 513), (16, 2048)]


def test_gla_wide_path_starts_past_a_blocks_shared_memory(cuda):
    from repro_torch.kernels.gla_scan import wide_path

    assert not wide_path(16, 64) and not wide_path(64, 128)
    assert all(wide_path(dk, dv) for dk, dv in GLA_WIDE)


def _gla_terms_rel(y, want, q, k, v, log_a):
    """f32: max over y's rows of max |y − want| / the row's largest term
    magnitude: the plain version on |q|, |k|, |v| (every product and
    partial sum of a row is at most that). At dk = 512 a row of y is
    (q_t·k_τ)-weighted and q·k can cancel to any fraction of its 512
    terms, so two f32 summation orders (the kernel's in dk order, cuBLAS's
    for the plain version's products) part by more than 1e-5 of such a
    row itself (measured 2.6e-5 at S = 1); the repository holds such
    ill-posed f32 sums on their terms' magnitudes."""
    scale, _ = gla_forward_plain(q.abs(), k.abs(), v.abs(), log_a)
    got, want, scale = (x.float().flatten(0, -2) for x in (y, want, scale))
    assert torch.isfinite(got).all()
    return float(((got - want).abs().amax(-1) / scale.amax(-1)).max())


@pytest.mark.parametrize("dk,dv", GLA_WIDE)
@pytest.mark.parametrize("s", [1, 129, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gla_wide_kernel_matches_plain(cuda, dk, dv, s, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s + dk + dv)
    q, k = (_draw(cuda, (1, s, 2, dk), dtype, gen) for _ in range(2))
    v = _draw(cuda, (1, s, 2, dv), dtype, gen)
    log_a = -torch.nn.functional.softplus(torch.randn((1, s, 2), generator=gen, device=cuda))
    y, state = _launched("gla_forward", lambda: gla_forward(q, k, v, log_a))
    want_y, want_state = gla_forward_plain(q, k, v, log_a)
    assert y.dtype == dtype and state.dtype == torch.float32
    if dtype == torch.float32:
        assert _gla_terms_rel(y, want_y, q, k, v, log_a) <= 1e-5
    else:
        assert _row_rel(y, want_y) <= 2 ** -8
    assert _row_rel(state, want_state) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gla_wide_kernel_on_a_misaligned_view(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(13)
    b, s, h, dk, dv = 1, 300, 2, 128, 128

    def view(shape):
        flat = _draw(cuda, (int(np.prod(shape)) + 1,), dtype, gen)
        return flat[1:].view(shape)

    q, k, v = view((b, s, h, dk)), view((b, s, h, dk)), view((b, s, h, dv))
    log_a = -torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=cuda))
    y, state = _launched("gla_forward", lambda: gla_forward(q, k, v, log_a))
    want_y, want_state = gla_forward_plain(q, k, v, log_a)
    if dtype == torch.float32:
        assert _gla_terms_rel(y, want_y, q, k, v, log_a) <= 1e-5
    else:
        assert _row_rel(y, want_y) <= 2 ** -8
    assert _row_rel(state, want_state) <= 1e-5


def test_model_on_the_card_is_the_cpu_model(cuda):
    """Reduced hymba-1.5b (f32): prefill logits, features and caches, and 3
    decode steps, card against CPU on the same weights and tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get_config("hymba-1.5b").reduced()
    cpu = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(cuda)

    card = to_card(cpu)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 100)))
    before = launch_counts()
    lg_g, c_g, f_g = prefill(card, cfg, tokens.to(cuda), cache_len=104)
    after = launch_counts()
    assert after["flash_attention"] - before["flash_attention"] == 1  # the global layer
    assert after["gla_forward"] - before["gla_forward"] == 2          # both layers
    lg_c, c_c, f_c = prefill(cpu, cfg, tokens, cache_len=104)
    assert _rel(lg_g.cpu(), lg_c) <= 1e-4 and _rel(f_g.cpu(), f_c) <= 1e-4
    for kind in c_c:
        for name in c_c[kind]:
            assert _rel(c_g[kind][name].cpu(), c_c[kind][name]) <= 1e-4, (kind, name)
    tok = lg_c.argmax(-1)
    for i in range(3):
        lg_g, c_g = decode_step(card, cfg, tok.to(cuda), c_g, 100 + i, max_seq=104)
        lg_c, c_c = decode_step(cpu, cfg, tok, c_c, 100 + i, max_seq=104)
        assert _rel(lg_g.cpu(), lg_c) <= 1e-4, i
        tok = lg_c.argmax(-1)


# the rest of the model zoo's attention at full width: cross attention
# (seamless, 512 text queries or one decode query against 1024 frames, H 16,
# hd 64; the VLM, against 1601 patches, H 32, hd 128), the seamless
# encoder's bidirectional self attention (1024 frames), and granite-moe's
# (H 24, hd 64) and arctic's (H 56, hd 128) causal prefills
ZOO_FLASH = [(4, 512, 1024, 16, 64, False), (4, 1, 1024, 16, 64, False),
             (4, 1024, 1024, 16, 64, False), (4, 512, 1601, 32, 128, False),
             (4, 1, 1601, 32, 128, False), (4, 512, 512, 24, 64, True),
             (4, 512, 512, 56, 128, True)]


@pytest.mark.parametrize("b,sq,sk,h,hd,causal", ZOO_FLASH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_on_the_zoo_shapes(cuda, b, sq, sk, h, hd, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + hd)
    q = _draw(cuda, (b, sq, h, hd), dtype, gen)
    k, v = (_draw(cuda, (b, sk, h, hd), dtype, gen) for _ in range(2))
    got = _launched("flash_attention", lambda: flash_attention(q, k, v, causal=causal))
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    assert _row_rel(got, want) <= (1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gla_kernel_at_the_mlstm_shape(cuda, dtype):
    """xlstm-1.3b's prefill: dk 512, dv 513 (v with its ones column), H 4,
    B 4, S 512, on the wide path."""
    gen = torch.Generator(device=cuda).manual_seed(513)
    b, s, h, dk, dv = 4, 512, 4, 512, 513
    q, k = (_draw(cuda, (b, s, h, dk), dtype, gen) for _ in range(2))
    v = _draw(cuda, (b, s, h, dv), dtype, gen)
    log_a = -torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=cuda))
    y, state = _launched("gla_forward", lambda: gla_forward(q, k, v, log_a))
    want_y, want_state = gla_forward_plain(q, k, v, log_a)
    if dtype == torch.float32:
        assert _gla_terms_rel(y, want_y, q, k, v, log_a) <= 1e-5
    else:
        assert _row_rel(y, want_y) <= 2 ** -8
    assert _row_rel(state, want_state) <= 1e-5


ZOO = ["xlstm-1.3b", "granite-moe-3b-a800m", "arctic-480b", "seamless-m4t-medium",
       "llama-3.2-vision-11b"]


@pytest.mark.parametrize("name", ZOO)
def test_zoo_model_on_the_card_is_the_cpu_model(cuda, name):
    """Each of the rest of the zoo, reduced (f32): prefill logits, features
    and caches, forward's aux vector and 3 decode steps, card against CPU on
    the same weights, tokens and stub embeddings, at 1e-4 (the aux's
    dropped fraction exactly); the prefill launches flash_attention once a
    layer that attends (encoder, self and cross) and gla_forward once an
    mLSTM layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, encoder_forward, forward, init_params, prefill

    cfg = get_config(name).reduced()
    cpu = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(cuda)

    card = to_card(cpu)
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 100)))
    fe = None
    if cfg.frontend is not None:
        fe = torch.from_numpy(rng.standard_normal((2, cfg.n_frontend_tokens, cfg.d_frontend),
                                                  dtype=np.float32))
    fe_g = None if fe is None else fe.to(cuda)
    pattern = cfg.layer_pattern()
    flash = (sum(k in ("dense", "swa", "moe", "arctic", "dec", "xattn") for k in pattern)
             + pattern.count("dec") + cfg.encoder_layers)
    before = launch_counts()
    lg_g, c_g, f_g = prefill(card, cfg, tokens.to(cuda), frontend=fe_g, cache_len=104)
    after = launch_counts()
    assert after["flash_attention"] - before["flash_attention"] == flash
    assert after["gla_forward"] - before["gla_forward"] == pattern.count("mlstm")
    lg_c, c_c, f_c = prefill(cpu, cfg, tokens, frontend=fe, cache_len=104)
    assert _rel(lg_g.cpu(), lg_c) <= 1e-4 and _rel(f_g.cpu(), f_c) <= 1e-4
    for kind in c_c:
        for leaf in c_c[kind]:
            assert _rel(c_g[kind][leaf].cpu(), c_c[kind][leaf]) <= 1e-4, (kind, leaf)
    aux_g = forward(card, cfg, tokens.to(cuda), frontend=fe_g)[1].cpu()
    aux_c = forward(cpu, cfg, tokens, frontend=fe)[1]
    assert float(aux_g[2]) == float(aux_c[2])
    assert torch.allclose(aux_g[:2], aux_c[:2], rtol=1e-4, atol=1e-7)
    enc_g = None if fe is None else encoder_forward(card, cfg, fe_g)
    enc_c = None if fe is None else encoder_forward(cpu, cfg, fe)
    tok = lg_c.argmax(-1)
    for i in range(3):
        lg_g, c_g = decode_step(card, cfg, tok.to(cuda), c_g, 100 + i, enc_out=enc_g, max_seq=104)
        lg_c, c_c = decode_step(cpu, cfg, tok, c_c, 100 + i, enc_out=enc_c, max_seq=104)
        assert _rel(lg_g.cpu(), lg_c) <= 1e-4, i
        tok = lg_c.argmax(-1)


def test_to_f8_on_the_card_is_the_cpus(cuda):
    """The float8 cache's rounding (``to_f8``: ties to even, NaN past ±464)
    gives the same bits on the card as on the CPU, f32 and bf16."""
    from repro_torch.models.blocks import to_f8

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(1 << 16) * s for s in (1e-3, 1.0, 30.0, 300.0)]
                       + [[448.0, 456.0, 464.0, 464.01, 480.0, -1e4, np.inf, np.nan]])
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x.astype(np.float32)).to(dtype)
        got = to_f8(xt.to(cuda)).view(torch.uint8).cpu()
        assert torch.equal(got, to_f8(xt).view(torch.uint8)), dtype


def test_f8_cache_on_the_card(cuda):
    """Reduced granite-3-2b with a float8 KV cache: on the card the prefill's
    cache is its f32 cache rounded by ``to_f8``, bit for bit, and a decode
    step writes its slot through the uint8 view and attends over the bf16
    upcast: logits at 2^-8 of the CPU's on the same float8 caches (the
    card's, copied to the CPU before each step). That attention rounds p
    and p·v to bf16, as the reference's does, and the two devices' orders of
    the sum may round an output to the other bf16 neighbour (``chip_smoke.py``'s
    ``F8_DECODE_REL``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.blocks import to_f8

    base = get_config("granite-3-2b").reduced()
    cfg = dataclasses.replace(base, kv_cache_dtype="float8_e4m3fn")
    cpu = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(cuda)

    card = to_card(cpu)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (2, 60))).to(cuda)
    _, c8, _ = prefill(card, cfg, tokens, cache_len=64)
    _, c32, _ = prefill(card, base, tokens, cache_len=64)
    for leaf in ("k", "v"):
        assert c8["dense"][leaf].dtype == torch.float8_e4m3fn
        assert torch.equal(c8["dense"][leaf].view(torch.uint8),
                           to_f8(c32["dense"][leaf]).view(torch.uint8)), leaf
    tok = tokens[:, -1]
    for i in range(3):
        c_cpu = {"dense": {leaf: t.cpu() for leaf, t in c8["dense"].items()}}
        lg_g, c8 = decode_step(card, cfg, tok, c8, 60 + i, max_seq=64)
        lg_c, c_cpu = decode_step(cpu, cfg, tok.cpu(), c_cpu, 60 + i, max_seq=64)
        assert _rel(lg_g.cpu(), lg_c) <= 2 ** -8, i
        tok = lg_g.argmax(-1)


# ------------------------------------------------- registered activations

# a new name, and a built-in name registered again with another function:
# neither has a code of the kernels', so both take the identity projection
# and the registered function applied by the wrapper
_REGISTERED = {
    "softplus_test": lambda x: torch.log1p(torch.exp(-x.abs())) + torch.clamp_min(x, 0.0),
    "tanh": lambda x: 1.7159 * torch.tanh(x * (2.0 / 3.0)),
}


@pytest.fixture(params=sorted(_REGISTERED))
def registered(request, cuda):
    from repro_torch.core import activations

    name = request.param
    saved = activations._REGISTRY.get(name)
    activations.register_activation(name, _REGISTERED[name])
    try:
        yield name
    finally:
        if saved is None:
            activations._REGISTRY.pop(name, None)
        else:
            activations._REGISTRY[name] = saved


@pytest.mark.parametrize("m", [1, 4, 33, 512])
def test_hidden_proj_kernel_takes_a_registered_activation(cuda, registered, m):
    """k=1 (one cluster kernel) and split (past four rows) shapes: one
    launch, the registered function applied once to the finished sum."""
    x, a = _randn(cuda, (m, 561), seed=31) * 0.1, _randn(cuda, (561, 128), seed=32)
    b = _randn(cuda, (128,), seed=33)
    before = launch_counts()["hidden_proj"]
    got = hidden_proj(x, a, b, activation=registered)
    torch.cuda.synchronize()
    assert launch_counts()["hidden_proj"] == before + 1
    pre = hidden_proj(x, a, b, activation="identity")
    assert torch.equal(got, _REGISTERED[registered](pre))
    assert _proj_err(x, a, b, registered) <= 1e-6


@pytest.mark.parametrize("d,t,n,nh", [(13, 17, 37, 10), (6, 32, 561, 128), (4, 9, 561, 384)])
def test_ingest_kernel_takes_a_registered_activation(cuda, registered, d, t, n, nh):
    """The split C entry: projection with the identity code, the function
    on the hidden rows, then the P chain, β and loss kernels (the wide
    ones at Ñ = 384); one launch, held to the plain version at 1e-4."""
    fleet = _fleet(cuda, "identity", 1.0, d=d, n=n, nh=nh, seed=3)
    fleet = fleet.replace(activation=registered)
    win = torch.from_numpy(
        np.random.default_rng(4).uniform(-1, 1, (d, t, n)).astype(np.float32) * 0.2).to(cuda)
    before = launch_counts()["fleet_ingest"]
    got, loss = fleet_ingest(fleet, win)
    torch.cuda.synchronize()
    assert launch_counts()["fleet_ingest"] == before + 1
    ref, ref_loss = fleet_ingest_plain(fleet, win)
    assert _rel(got.p, ref.p) < 1e-4
    assert _rel(got.beta, ref.beta) < 1e-4
    assert _rel(loss, ref_loss) < 1e-4


# ------------------------------------------------------------- snapshots


def _small_runtime(device, tmp, *, hardened=False):
    from repro_torch.fleet import FaultInjector, FaultSpec, RobustConfig
    from repro_torch.runtime import FleetRuntime, GovernorConfig, RuntimeConfig
    from repro_torch.scenarios import make_scenario, scenario_topology

    sc = make_scenario("har", n_devices=6, ticks=24, batch=3, n_hidden=10).build()
    extra = {}
    if hardened:
        extra = dict(robust=RobustConfig(trim=1), faults=FaultInjector((
            FaultSpec(kind="scale", devices=(1,), magnitude=-25.0, start_tick=4),
            FaultSpec(kind="nan", devices=(4,), start_tick=7, period=8)), 6))
    config = RuntimeConfig(topology=scenario_topology("star", 6), ridge=sc.spec.ridge,
                           detector=sc.spec.detector, governor=GovernorConfig(merge_every=4),
                           snapshot_dir=tmp, **extra)
    fleet = sc.init_fleet(torch.Generator().manual_seed(0), device=device)
    return sc.feed(), FleetRuntime(fleet, config, device=device)


@pytest.mark.parametrize("hardened", [False, True])
@pytest.mark.parametrize("source,target", [("cuda", "cpu"), ("cpu", "cuda")])
def test_snapshot_crosses_between_card_and_cpu(cuda, tmp_path, source, target, hardened):
    """A snapshot written on one device restores on the other bit for bit,
    and the restored runtime ticks on beside the writer: flags, decisions
    and non-finite counts equal, losses at the card-against-CPU bounds of
    chip_smoke.py phase 4 (2e-4; 5e-4 after a hardened merge)."""
    feed, writer = _small_runtime(source, tmp_path, hardened=hardened)
    for t in range(12):
        writer.tick(feed.tick_batch(t))
    writer.snapshot()
    _, reader = _small_runtime(target, tmp_path, hardened=hardened)
    assert reader.restore() == 12
    assert reader.states.beta.device.type == target
    assert torch.equal(reader.states.beta.cpu(), writer.states.beta.cpu())
    assert torch.equal(reader.states.p.cpu(), writer.states.p.cpu())
    assert torch.equal(reader.det.ewma.cpu(), writer.det.ewma.cpu())
    if hardened:
        assert torch.equal(reader._last_good.cpu(), writer._last_good.cpu())
    rtol = 5e-4 if hardened else 2e-4
    for t in range(12, feed.n_ticks):
        a, b = reader.tick(feed.tick_batch(t)), writer.tick(feed.tick_batch(t))
        live = np.isfinite(b.losses)
        np.testing.assert_allclose(a.losses[live], b.losses[live], rtol=rtol, atol=1e-6)
        assert np.array_equal(a.drifted, b.drifted)
        assert a.decision == b.decision
        assert a.nonfinite_payloads == b.nonfinite_payloads


# ---------------------------------------------------- the serving front-end


def _serving(device, d=16, n=16, nh=8, seed=0):
    """A ring-hops-2 fleet behind a ServeFrontend, one basis from a CPU
    generator: the same initial fleet on either device."""
    from repro_torch.fleet import init_fleet
    from repro_torch.obs import TelemetryConfig
    from repro_torch.runtime import FleetRuntime, GovernorConfig, RuntimeConfig

    x_init = np.random.default_rng(seed).normal(size=(d, 2 * nh, n)).astype(np.float32)
    fleet = init_fleet(torch.Generator().manual_seed(seed), d, n, nh, x_init,
                       activation="identity", ridge=1e-3, device=device)
    return FleetRuntime(fleet, RuntimeConfig(
        topology=ring(d, hops=2), governor=GovernorConfig(merge_every=4),
        telemetry=TelemetryConfig(trace=False)), device=device)


def _serve_waves(runtime, waves=12, d=16, n=16, seed=1):
    """One full window a wave (a request a device, ``close_at_requests`` =
    D): the acks, with no deadline or stall threshold in reach."""
    import asyncio

    from repro_torch.serve import SampleRequest, ServeConfig, ServeFrontend

    fe = ServeFrontend(runtime, ServeConfig(batch=2, close_at_requests=d, max_delay_s=600.0,
                                            tick_deadline_s=600.0))
    rng = np.random.default_rng(seed)
    reqs = [[SampleRequest(device=dev, x=rng.normal(size=(2, n)).astype(np.float32))
             for dev in range(d)] for _ in range(waves)]

    async def drive():
        await fe.start()
        _lib.reset_launch_counts()
        acks = []
        for wave in reqs:
            acks.append(await asyncio.gather(*[fe.submit(r) for r in wave]))
        await fe.stop()
        return acks

    return fe, asyncio.run(drive())


@pytest.fixture(scope="module")
def served_on_card():
    """The steady leg at D = 16 on the card, once for the tests below."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rt = _serving(torch.device("cuda"))
    _lib.library()
    loads = _lib.library.cache_info().misses
    fe, acks = _serve_waves(rt)
    return rt, fe, acks, launch_counts(), loads


def test_frontend_serves_on_the_card_every_ack_ok(served_on_card):
    """Every ack ok, and the acks' scores, ticks and flags those of the same
    waves through the CPU front-end (scores at phase 4's bounds)."""
    rt, fe, acks, _, _ = served_on_card
    assert fe.failed is None
    assert all(a.ok for wave in acks for a in wave)
    _, cpu_acks = _serve_waves(_serving("cpu"))
    for got, want in zip(acks, cpu_acks, strict=True):
        assert [(a.status, a.tick, a.drifted) for a in got] == [
            (a.status, a.tick, a.drifted) for a in want]
        np.testing.assert_allclose([a.score for a in got], [a.score for a in want],
                                   rtol=2e-4, atol=1e-6)


def test_frontend_warms_up_on_its_worker_with_no_build_after(served_on_card):
    """The tick worker ran the warm-up on its own thread; the kernel
    library was loaded once, before the first live tick."""
    _, fe, _, _, loads = served_on_card
    assert fe.warmup_thread == "serve-tick-worker"
    assert _lib.library.cache_info().misses == loads == 1


def test_frontend_launches_equal_ticks_and_merges(served_on_card):
    """One ingest launch a tick and one fused merge+solve a merge round,
    counted from after the warm-up."""
    rt, _, _, counts, _ = served_on_card
    assert rt.tick_no == 12 and rt.governor.state.merges == 3
    assert counts["fleet_ingest"] == rt.tick_no
    assert counts["banded_merge_solve"] == rt.governor.state.merges


# ----------------------------------------------------- the cohort-paged arena

@pytest.mark.parametrize("c,nh,n,t", [(16384, 4, 8, 4), (13, 10, 37, 17), (64, 128, 561, 32)])
def test_paged_ingest_kernel_matches_plain(cuda, c, nh, n, t):
    """``fleet_ingest_paged`` on a page's raw leaves against the plain
    ingest of the same page (the ingest's 1e-4), one launch a call; the
    cohort bench's page (16 384 devices at Ñ = 4) among the shapes."""
    from repro_torch.kernels import fleet_ingest_paged

    g = torch.Generator(device="cuda").manual_seed(0)
    alpha = torch.rand((n, nh), generator=g, device=cuda) * 2 - 1
    bias = torch.rand((nh,), generator=g, device=cuda) * 2 - 1
    x0 = torch.randn((c, 2 * nh + 8, n), generator=g, device=cuda) * 0.5
    st = init_oselm(SLFNParams(alpha, bias), x0, x0, activation="identity", ridge=1e-2)
    window = torch.randn((c, t, n), generator=g, device=cuda) * 0.5
    _lib.reset_launch_counts()
    got = fleet_ingest_paged(st.p, st.beta, alpha, bias, window, activation="identity")
    assert launch_counts()["fleet_ingest"] == 1
    ref_st, ref_l = fleet_ingest_plain(st, window)
    for g_, w_ in zip(got, (ref_st.p, ref_st.beta, ref_l)):
        assert _rel(g_, w_) <= 1e-4


def _cohort_fleet(d=64, nh=4, n=8, seed=0):
    from repro_torch.fleet import FleetArena, init_fleet

    rng = np.random.default_rng(seed)
    x0 = (rng.standard_normal((d, 16, n)) * 0.5).astype(np.float32)
    fleet = init_fleet(torch.Generator().manual_seed(seed), d, n, nh, x0, ridge=1e-2,
                       device="cpu")
    return FleetArena.from_fleet(fleet)


def _arena_copy(arena):
    from repro_torch.fleet import FleetArena

    return FleetArena(alpha=arena.alpha.clone(), bias=arena.bias.clone(), p=arena.p.clone(),
                      beta=arena.beta.clone())


COHORT_TOPOS = {
    "star": lambda d: star(d),
    "all_to_all": lambda d: all_to_all(d),
    "ring_closed": lambda d: ring(d, hops=d // 2),
    "hierarchical_isolated": lambda d: hierarchical(d, 6, head_exchange=False),
    "ring": lambda d: ring(d, hops=2),
}


@pytest.mark.parametrize("topo", sorted(COHORT_TOPOS))
def test_cohort_merge_pages_on_the_card_match_the_cpu(cuda, topo):
    """One masked two-tier round on the card, its pages through the copy
    streams and the merge kernels, against the same round on the CPU (the
    plain versions): P and β at phase 4's 2e-4 of their largest,
    non-participants bit for bit, the segment sum once a page and the solve
    once a round (``global``, ``clusters``) or once a page (``ring``)."""
    from repro_torch.fleet import CohortMerger, CohortSchedule

    base = _cohort_fleet()
    d, c = base.n_devices, 16
    mask = np.random.default_rng(1).random(d) > 0.25
    mask[:2] = True
    sched = CohortSchedule(d, c)
    card, cpu = _arena_copy(base), _arena_copy(base)
    merger = CohortMerger(COHORT_TOPOS[topo](d), sched, ridge=1e-2, device=cuda)
    _lib.reset_launch_counts()
    merger.merge(card, mask)
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == merger.launches_per_round(), counts
    assert card.p.is_pinned() and card.beta.is_pinned()
    CohortMerger(COHORT_TOPOS[topo](d), sched, ridge=1e-2, device="cpu").merge(cpu, mask)
    assert _rel(card.p, cpu.p) <= 2e-4 and _rel(card.beta, cpu.beta) <= 2e-4
    skip = torch.as_tensor(~mask)
    assert torch.equal(card.p[skip], base.p[skip]) and torch.equal(card.beta[skip], base.beta[skip])


@pytest.mark.parametrize("topo", ["star", "hierarchical_isolated", "ring"])
@pytest.mark.parametrize("active", [None, 3])
def test_paged_runtime_on_the_card_matches_the_cpu(cuda, topo, active):
    """CohortFleetRuntime at D = 64 in cohorts of 16 on the card against the
    same runtime on the CPU over 12 ticks: flags, detections and decisions
    equal, losses at phase 4's rtol 2e-4, after the first merge at the
    larger of that and twice the CPU's own spread between the paged and the
    resident runtime on the same ticks (the same merges summed in another
    order, amplified by the Gauss-Jordan solves); the arena pinned; after
    the warm-up no library load, and the runtime's launch check holds."""
    from repro_torch.runtime import (CohortFleetRuntime, DetectorConfig, FleetRuntime,
                                     GovernorConfig, RuntimeConfig)

    base = _cohort_fleet()
    d = base.n_devices
    cfg = RuntimeConfig(topology=COHORT_TOPOS[topo](d), ridge=1e-2,
                        detector=DetectorConfig(warmup=4, warmup_skip=1),
                        governor=GovernorConfig(merge_every=3))
    card = CohortFleetRuntime(_arena_copy(base), cfg, cohort_size=16, active_per_tick=active,
                              device=cuda)
    cpu = CohortFleetRuntime(_arena_copy(base), cfg, cohort_size=16, active_per_tick=active,
                             device="cpu")
    resident = FleetRuntime(_arena_copy(base).to_fleet(device="cpu"), cfg, device="cpu")
    assert card.arena.p.is_pinned() and card.arena.beta.is_pinned()
    card.warmup(4)
    loads = _lib.library.cache_info().misses
    rng = np.random.default_rng(2)
    got, want, spread, merged = [], [], 0.0, False
    for t in range(12):
        batch = rng.normal(scale=0.5, size=(d, 4, 8)).astype(np.float32)
        batch[3] += 2.0 * (t >= 8)
        a, b = card.tick(batch), cpu.tick(batch)
        r = resident.tick(batch, served=b.served)
        keep = np.ones(d, bool) if b.served is None else b.served
        assert np.array_equal(a.drifted, b.drifted) and np.array_equal(
            a.fresh_detections, b.fresh_detections)
        assert (a.decision.merge, a.decision.participants) == (
            b.decision.merge, b.decision.participants)
        if merged:
            spread = max(spread, float(np.max(np.abs(b.losses[keep] - r.losses[keep])
                                              / np.abs(r.losses[keep]))))
            got.append(a.losses[keep])
            want.append(b.losses[keep])
        else:
            np.testing.assert_allclose(a.losses, b.losses, rtol=2e-4, atol=1e-6)
        merged |= a.decision.merge
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               rtol=max(2e-4, 2 * spread), atol=1e-6)
    assert card.merge_round >= 2 and _lib.library.cache_info().misses == loads == 1
    card.assert_compile_once()
    paging = card.last_paging
    assert paging["in_s"] > 0 and paging["out_s"] > 0 and paging["compute_s"] > 0


# ------------------------------------------------------------ training

# (B, Sq, Sk, H, hd, causal, dtype): chip_smoke.py phase 20 (a)'s shapes; then
# the tensor-core route's edges (Sq and Sk off 64, causal Sq > Sk, Sk < 64,
# hd 80 and 200 on masked instances) and the CUDA cores' (f32, hd 100 in bf16)
FLASH_BWD = [(8, 128, 128, 4, 256, True, torch.bfloat16), (2, 2048, 2048, 4, 256, True, torch.bfloat16),
             (8, 512, 512, 32, 64, True, torch.bfloat16), (4, 512, 512, 32, 128, True, torch.bfloat16),
             (4, 512, 1601, 32, 128, False, torch.bfloat16), (2, 512, 512, 8, 256, True, torch.float32),
             (3, 200, 333, 5, 96, False, torch.bfloat16), (1, 77, 77, 2, 80, True, torch.float32),
             (2, 77, 190, 3, 128, False, torch.bfloat16), (2, 130, 77, 3, 64, True, torch.bfloat16),
             (1, 100, 40, 2, 256, True, torch.bfloat16), (2, 33, 20, 2, 256, False, torch.bfloat16),
             (2, 45, 45, 2, 80, True, torch.bfloat16), (2, 150, 150, 2, 200, True, torch.bfloat16),
             (2, 70, 70, 3, 100, True, torch.bfloat16)]
# f32: sums in other orders; bf16: a result rounded to the other neighbour,
# one bf16 step of the largest entry's binade (chip_smoke.py's BWD_TOL)
FLASH_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
BWD_KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")
WIDE_BWD_KERNELS = ("flash_bwd_wide_dq_kernel", "flash_bwd_wide_dkdv_kernel")
# past hd 256 the wide pair, f32 and bf16: S 77 and 512, causal and not, and a
# single query row against 77 keys, not causal. (A query that sees one key,
# as causal row 0 does, has p = 1, so dp − δ cancels and its dq and the key's
# dk are 0 but for rounding: a bound relative to their largest magnitude
# would measure noise.)
FLASH_BWD_WIDE = [(2, s, s, 2, hd, causal, dtype) for hd in (320, 512) for s in (77, 512)
                  for causal in (True, False) for dtype in (torch.float32, torch.bfloat16)] + \
                 [(2, 1, 77, 2, hd, False, dtype) for hd in (320, 512)
                  for dtype in (torch.float32, torch.bfloat16)]


def _bwd_kernels_run(fn, kernels=BWD_KERNELS) -> list[str]:
    """The names of the backward kernels (those named by ``kernels``) one
    call of ``fn`` launched, from torch.profiler. The profiler may drop a
    launch from its record, so a session that did not see both kernels is
    run again, up to twice."""
    from torch.profiler import ProfilerActivity, profile

    names = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if any(k in e.key for k in kernels)]
        if all(any(k in n for n in names) for k in kernels):
            return names
    return names


def _check_backward(q, k, v, dout, causal, route: str):
    """flash_attention_bwd on the card against its plain version, the same
    bits on a second call, one launch count a call, and its route: the
    tensor cores' pair ("mma"), the CUDA cores' ("cuda") or, past hd 256,
    the wide pair ("wide")."""
    from repro_torch.kernels import flash_attention_bwd, flash_attention_bwd_plain
    from repro_torch.kernels import flash_attention_fwd

    dtype = q.dtype
    out, m, l = flash_attention_fwd(q, k, v, causal=causal)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal))
    _, m_plain, l_plain = flash_attention_plain(q, k, v, causal=causal, stats=True)
    assert float((m - m_plain).abs().max()) <= 1e-5 * float(m_plain.abs().max())
    assert _rel(l, l_plain) <= 1e-5
    before = launch_counts()["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, out, dout, m, l, causal=causal)
    assert launch_counts()["flash_attention_bwd"] == before + 1
    again = flash_attention_bwd(q, k, v, out, dout, m, l, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, out, dout, m, l, causal=causal)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and torch.equal(g, a)  # no atomics: the same bits
        assert _rel(g.float(), w.float()) <= FLASH_BWD_TOL[dtype]
    kernels = WIDE_BWD_KERNELS if route == "wide" else BWD_KERNELS
    names = _bwd_kernels_run(lambda: flash_attention_bwd(q, k, v, out, dout, m, l, causal=causal),
                             kernels)
    assert len(names) == 2 and all(("_mma<" in n) == (route == "mma") for n in names), names


@pytest.mark.parametrize("shape", FLASH_BWD, ids=lambda s: "-".join(map(str, s)))
def test_flash_backward_kernel_matches_plain(cuda, shape):
    b, sq, sk, h, hd, causal, dtype = shape
    gen = torch.Generator(device=cuda).manual_seed(sq + hd)
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, sk, h, hd), generator=gen, device=cuda).to(dtype) for _ in range(2))
    dout = torch.randn((b, sq, h, hd), generator=gen, device=cuda).to(dtype)
    _check_backward(q, k, v, dout, causal, "mma" if dtype == torch.bfloat16 and hd % 8 == 0
                    else "cuda")


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_backward_kernel_on_a_misaligned_view(cuda, hd):
    """bf16 views one element into their storage (2 bytes, off the tensor
    cores' 16-byte copies): the CUDA cores' pair, held to the same bound."""
    gen = torch.Generator(device=cuda).manual_seed(hd + 1)
    shape = (2, 150, 3, hd)

    def view():
        flat = _draw(cuda, (int(np.prod(shape)) + 1,), torch.bfloat16, gen)
        return flat[1:].view(shape)

    q, k, v, dout = view(), view(), view(), view()
    _check_backward(q, k, v, dout, causal=True, route="cuda")


@pytest.mark.parametrize("shape", FLASH_BWD_WIDE, ids=lambda s: "-".join(map(str, s)))
def test_flash_backward_wide_matches_plain(cuda, shape):
    """Past hd 256: the wide pair (one launch count, two kernels), within
    FLASH_BWD_TOL of the plain version, the same bits twice."""
    b, sq, sk, h, hd, causal, dtype = shape
    gen = torch.Generator(device=cuda).manual_seed(sq + hd + causal)
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, sk, h, hd), generator=gen, device=cuda).to(dtype) for _ in range(2))
    dout = torch.randn((b, sq, h, hd), generator=gen, device=cuda).to(dtype)
    _check_backward(q, k, v, dout, causal, route="wide")


def test_flash_function_backward_past_hd_256(cuda):
    """FlashAttention's autograd backward at hd 320 runs the wide pair once
    and gives the CPU's gradients."""
    gen = torch.Generator(device=cuda).manual_seed(320)
    q = torch.randn((2, 70, 3, 320), generator=gen, device=cuda).requires_grad_(True)
    k = torch.randn((2, 70, 3, 320), generator=gen, device=cuda).requires_grad_(True)
    out = flash_attention(q, k, k, causal=True)
    before = launch_counts()["flash_attention_bwd"]
    out.sum().backward()
    assert launch_counts()["flash_attention_bwd"] == before + 1
    qc, kc = (t.detach().cpu().requires_grad_(True) for t in (q, k))
    flash_attention(qc, kc, kc, causal=True).sum().backward()
    assert _rel(q.grad.cpu(), qc.grad) <= 1e-5 and _rel(k.grad.cpu(), kc.grad) <= 1e-5


def test_flash_function_on_the_card_has_a_backward(cuda):
    q = torch.randn((2, 70, 3, 64), device=cuda, requires_grad=True)
    k = torch.randn((2, 70, 3, 64), device=cuda, requires_grad=True)
    out = flash_attention(q, k, k, causal=True)
    assert out.grad_fn is not None
    before = launch_counts()["flash_attention_bwd"]
    out.sum().backward()
    assert launch_counts()["flash_attention_bwd"] == before + 1
    qc, kc = (t.detach().cpu().requires_grad_(True) for t in (q, k))
    flash_attention(qc, kc, kc, causal=True).sum().backward()
    assert _rel(q.grad.cpu(), qc.grad) <= 1e-5 and _rel(k.grad.cpu(), kc.grad) <= 1e-5


# (B, S, H, dk, dv, dtype): chip_smoke.py phase 20 (a)'s shapes, reduced
# (hymba-1.5b's Mamba heads in bf16 and f32, xLSTM's mLSTM past one block's
# tiles, S off the chunk), then S inside one chunk and widths off the tiles
# (24 × 40 in both types: dk not a multiple of 16)
GLA_BWD = [(2, 256, 25, 16, 64, torch.bfloat16), (2, 256, 25, 16, 64, torch.float32),
           (1, 256, 4, 512, 513, torch.bfloat16), (3, 200, 5, 16, 64, torch.float32),
           (2, 70, 3, 24, 40, torch.float32), (1, 300, 2, 64, 65, torch.bfloat16),
           (2, 70, 3, 24, 40, torch.bfloat16)]
# max |kernel − plain| / max |plain| of each of dq, dk, dv, dlog a: f32 sums
# in other orders; bf16 results rounded once from f32 values that differ in
# their last bits (chip_smoke.py's GLA_BWD_TOL)
GLA_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
# the backward's kernels: (bf16 on the tensor cores, f32 on the CUDA cores);
# bf16 launches gla_bwd_pad_kernel first where rows are off its 16-byte copies
GLA_BWD_ROUTES = {torch.bfloat16: ("gla_bwd_state_mma_kernel", "gla_bwd_carry_kernel",
                                   "gla_bwd_chunk_mma_kernel", "gla_bwd_dlog_a_kernel"),
                  torch.float32: ("gla_bwd_state_kernel", "gla_bwd_carry_kernel",
                                  "gla_bwd_chunk_kernel", "gla_bwd_dlog_a_kernel")}
GLA_BWD_PAD = "gla_bwd_pad_kernel"


def _gla_inputs(device, b, s, h, dk, dv, dtype, seed):
    """q, k, v, dy in dtype, log a (decays of −softplus(N(0, 1))/4) and the
    final state's cotangent in f32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k = (torch.randn((b, s, h, dk), generator=gen, device=device).to(dtype) for _ in range(2))
    v, dy = (torch.randn((b, s, h, dv), generator=gen, device=device).to(dtype) for _ in range(2))
    log_a = -torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=device)) / 4
    dstate = torch.randn((b, h, dk, dv), generator=gen, device=device)
    return q, k, v, log_a, dy, dstate


def _gla_bwd_kernels_run(fn, want: int) -> list[str]:
    """The names of the kernels one call of ``fn`` launched whose name holds
    ``gla_bwd_``, from torch.profiler; a session that did not see ``want``
    is run again, up to twice (the profiler may drop a launch)."""
    from torch.profiler import ProfilerActivity, profile

    names = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key.split("::")[-1] for e in prof.key_averages() if "gla_bwd_" in e.key]
        if len(names) == want:
            return names
    return names


def _check_gla_backward(q, k, v, log_a, dy, ds):
    """gla_backward against its plain version on the same forward's states,
    with and without the final state's cotangent: each gradient in its
    operand's type, the same bits on a second call, one count a call; and
    its route, the kernels the profiler saw: the tensor cores' family for
    bf16 (with the pad kernel where a width is not a multiple of 8 or an
    operand is off a 16-byte boundary), the CUDA cores' for f32."""
    from repro_torch.kernels import gla_backward, gla_backward_plain
    from repro_torch.kernels.gla_scan import _forward

    _, state, states, decay = _forward(q, k, v, log_a, keep=True)
    for cot in (ds, None):
        before = launch_counts()["gla_backward"]
        got = gla_backward(q, k, v, log_a, dy, cot, states, decay, state)
        again = gla_backward(q, k, v, log_a, dy, cot, states, decay, state)
        assert launch_counts()["gla_backward"] == before + 2
        want = gla_backward_plain(q, k, v, log_a, dy, cot, states, decay, state)
        for g, a, w, t in zip(got, again, want, (q, k, v, log_a)):
            assert g.dtype == t.dtype and g.shape == t.shape and torch.equal(g, a)  # no atomics
            assert _rel(g.float(), w.float()) <= GLA_BWD_TOL[q.dtype]
    want = list(GLA_BWD_ROUTES[q.dtype])
    if q.dtype == torch.bfloat16 and (q.shape[-1] % 8 or v.shape[-1] % 8 or any(
            t.data_ptr() % 16 for t in (q, k, v, dy))):
        want.append(GLA_BWD_PAD)
    names = _gla_bwd_kernels_run(lambda: gla_backward(q, k, v, log_a, dy, ds, states, decay,
                                                      state), len(want))
    assert len(names) == len(want) and all(any(n.startswith(k) for n in names)
                                           for k in want), names


@pytest.mark.parametrize("shape", GLA_BWD, ids=lambda s: "-".join(map(str, s)))
def test_gla_backward_kernel_matches_plain(cuda, shape):
    b, s, h, dk, dv, dtype = shape
    _check_gla_backward(*_gla_inputs(cuda, b, s, h, dk, dv, dtype, s + dk))


def test_gla_backward_kernel_on_a_misaligned_view(cuda):
    """bf16 q, k, v and dy one element into their storage (2 bytes off the
    tensor cores' 16-byte copies): the wrapper copies them onto a boundary,
    the tensor-core route, held to the same bound."""
    q, k, v, log_a, dy, ds = _gla_inputs(cuda, 2, 150, 3, 16, 64, torch.bfloat16, 151)

    def view(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    q, k, v, dy = (view(t) for t in (q, k, v, dy))
    assert all(t.data_ptr() % 16 for t in (q, k, v, dy))
    _check_gla_backward(q, k, v, log_a, dy, ds)


def test_gla_refuses_a_gradient_on_the_card(cuda):
    """gla_forward on CUDA operands that require a gradient no longer
    refuses: it runs GLAForward, its backward launches gla_backward once,
    and the gradients equal the CPU's within 1e-5 of each one's largest."""
    cpu = _gla_inputs("cpu", 2, 200, 3, 16, 64, torch.float32, 9)
    grads = {}
    for where in ("cpu", "cuda"):
        leaves = [t.detach().to(where).requires_grad_(True) for t in cpu[:4]]
        dy, ds = (t.to(where) for t in cpu[4:])
        y, st = gla_forward(*leaves)
        assert type(y.grad_fn).__name__ == "GLAForwardBackward"
        before = launch_counts()["gla_backward"]
        ((y * dy).sum() + (st * ds).sum()).backward()
        assert launch_counts()["gla_backward"] == before + (where == "cuda")
        grads[where] = [t.grad for t in leaves]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert _rel(g.cpu(), w) <= 1e-5


@pytest.mark.parametrize("name", ["gemma3-1b", "granite-moe-3b-a800m", "hymba-1.5b",
                                  "xlstm-1.3b"])
def test_train_step_on_the_card_is_the_cpus(cuda, name):
    """Reduced (f32) configs, two sgd steps on the same weights and tokens:
    the loss within 1e-5, the gradient norm within 1e-4, the parameters'
    moves within 1e-4 of each leaf's largest move past f32 rounding. The
    GLA configs run S 200, past one chunk, so that the state's gradient is
    carried."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import sgd, tree_leaves

    cfg = get_config(name).reduced()
    cpu = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = _to(cpu, cuda)
    rng = np.random.default_rng(1)
    seq = 200 if name in ("hymba-1.5b", "xlstm-1.3b") else 96
    batches = [{k: torch.as_tensor(rng.integers(0, cfg.vocab, (4, seq))) for k in ("tokens",
                                                                               "labels")}
               for _ in range(2)]
    out = {}
    for where, params in (("cpu", cpu), ("cuda", card)):
        step, opt = make_train_step(cfg, sgd(0.5)), sgd(0.5)
        state, mets = opt.init(params), []
        for b in batches:
            params, state, met = step(params, state, {k: v.to(where) for k, v in b.items()})
            mets.append((float(met["loss"]), float(met["grad_norm"])))
        out[where] = (params, mets)
    for (lc, nc), (lg, ng) in zip(out["cpu"][1], out["cuda"][1]):
        assert abs(lg - lc) <= 1e-5 and abs(ng - nc) <= 1e-4 * nc
    for g, w, p0 in zip(tree_leaves(out["cuda"][0]), tree_leaves(out["cpu"][0]), tree_leaves(cpu)):
        move = float((w - p0).abs().max())
        rounding = 2 * float(np.spacing(np.float32(w.abs().max())))
        assert float((g.cpu() - w).abs().max()) - rounding <= 1e-4 * move


def _to(tree, device):
    return {k: _to(v, device) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(device)
