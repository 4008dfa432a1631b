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
arithmetic, its products summed in PyTorch's order). ``banded_merge_solve``
is held bit for bit at the har width: its loader sums each band in the
plain version's order and its elimination is ``from_uv_solve``'s; both
solves stay bit for bit past Ñ = 320, where they take the blocked wide
solve. The
model's prefill and decode on the card are held to the CPU's at 1e-4
(reduced hymba-1.5b, f32). A registered activation (a new name, or a
built-in name registered again) goes through ``hidden_proj`` (k=1 and
split) and ``fleet_ingest`` in one launch, at their plain versions'
bounds; a snapshot written on the card restores on the CPU bit for bit,
and the reverse, and ticks on at ``chip_smoke.py`` phase 4's bounds.
"""
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
# version's: no element differs, where an update rounded twice moves most of β
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
    for k in range(n):  # the same elimination, each update rounded twice
        row = x[:, k : k + 1] / x[:, k : k + 1, k : k + 1]
        col = x[:, :, k : k + 1] - eye[:, k : k + 1]
        x = (x.double() - col.double() * row.double()).float()
    assert int((x[:, :, 2 * n :] != rb).sum()) > rb.numel() // 2


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
    fleet = _fleet(cuda, "identity", 1.0)
    win = torch.zeros((D_ODD, 3, F_ODD), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        fleet_ingest(fleet, win)
    w = torch.zeros((5, 9, 4), device=cuda).transpose(1, 2)  # (5, 4, 9), strided
    with pytest.raises(ValueError, match="contiguous"):
        banded_merge_solve(w, 1)


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
# registers (0–4) and past them (5, 8: chains in shared memory)
@pytest.mark.parametrize("d,r,c,n_clusters", [(13, 10, 37, 4), (256, 128, 689, 32)])
@pytest.mark.parametrize("trim", [0, 1, 2, 4, 5, 8])
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
    a, b = _randn(cuda, (3, 50, 12), seed=10), _randn(cuda, (3, 50, 20), seed=11)
    assert _rel(matmul_atb(a, b), matmul_atb_plain(a, b)) <= 1e-6
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        matmul_atb(a.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        matmul_atb(a.transpose(1, 2).contiguous().transpose(1, 2), b)


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


def test_mix_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((5, 4, 9), device=cuda)
    with pytest.raises(ValueError, match="band"):
        banded_mix(x, 3)
    with pytest.raises(ValueError, match="band"):
        banded_mix(torch.zeros((454, 1, 4), device=cuda), 227)
    with pytest.raises(ValueError, match="contiguous"):
        banded_mix(x.transpose(1, 2), 1)
    with pytest.raises(TypeError, match="float32"):
        segment_sum_mix(x.double(), np.zeros(5, np.int32), 1)
    with pytest.raises(ValueError, match="contiguous"):
        segment_broadcast(x.transpose(1, 2), np.zeros(5, np.int32))
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
    q = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="must be"):
        flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(ValueError, match="differ"):
        flash_attention(q, q[..., :32].contiguous(), q[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        gla_forward(q[..., :16], q[..., :16], q, torch.zeros(1, 8, 2, device=cuda))
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
