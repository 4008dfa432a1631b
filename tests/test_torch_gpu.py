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
kernels' order. So is ``rank1_add`` (one rounded product, one fused
multiply-add in both). ``hidden_proj`` and ``matmul_atb`` are held at
1e-6 of max |plain|, f32 or bf16 inputs (widened to f32 exactly in both):
each kernel sums in a fixed order of its own, the plain version is a
PyTorch product (a batch of eight, at 1e-6 of an f64 product's largest
entry), and ``matmul_atb`` gives the same bits on a second call (its
slices of samples are added in a fixed order). For ``hidden_proj`` the
scale is the larger of max |plain| and max |x·α + b|: a saturating
activation shrinks the output but not the rounding of the product under
it. ``flash_attention`` and
``gla_forward`` are held row by row (a query's output, a token's y, a
row of the state), each row at its own max |plain|, so that late query
rows, whose values are a fraction of row 0's, count as much: flash at
1e-5 in f32 (the plain version's dot products are PyTorch's, in other
orders) and 2e-2 in bf16 (a p or an output that rounds to the other bf16
neighbour), GLA at 1e-5 and 2^-8 (its plain version repeats the kernel's
order). The model's prefill and decode on the card
are held to the CPU's at 1e-4 (reduced hymba-1.5b, f32).
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
from repro_torch.core.activations import ACTIVATION_CODES

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


# (32, 128, 561): the cluster solves of an isolated hierarchy at har width
@pytest.mark.parametrize("s,n,m", [(1, 10, 23), (3, 10, 23), (2, 128, 561), (32, 128, 561)])
def test_from_uv_solve_kernel_matches_plain(cuda, s, n, m):
    rng = np.random.default_rng(4)
    u = _spd(rng, s, n, cuda)
    v = torch.from_numpy(rng.standard_normal((s, n, m)).astype(np.float32)).to(cuda)
    w = torch.cat([u, v], dim=2)  # the solve reads column slices of a packed [U | V]
    p, b = from_uv_solve(w[:, :, :n], w[:, :, n:], ridge=1e-3)
    rp, rb = from_uv_solve_plain(u, v, ridge=1e-3)
    assert _rel(p, rp) < 1e-5
    assert _rel(b, rb) < 1e-5


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


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    fleet = _fleet(cuda, "identity", 1.0)
    win = torch.zeros((D_ODD, 3, F_ODD), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        fleet_ingest(fleet, win)
    w = torch.zeros((5, 9, 4), device=cuda).transpose(1, 2)  # (5, 4, 9), strided
    with pytest.raises(ValueError, match="contiguous"):
        banded_merge_solve(w, 1)


# (256, 128, 561): the har width, tile 0 exactly U, a ragged last tile of
# 49 columns; (13, 10, 300): tiles across the U | V seam, odd everything
@pytest.mark.parametrize("d,n,m", [(256, 128, 561), (13, 10, 300)])
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
# har width on 32 clusters, as a hierarchical fleet merges
@pytest.mark.parametrize("d,r,c,n_clusters", [(13, 10, 37, 4), (256, 128, 689, 32)])
@pytest.mark.parametrize("trim", [0, 1, 2, 4])
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
    with pytest.raises(ValueError, match="MAX_TRIM"):
        robust_segment_sum_mix(x, cids, mask, scale, n_clusters, 5)


# (13, 10, 37): everything odd; (256, 128, 689): the har width
@pytest.mark.parametrize("d,r,c", [(13, 10, 37), (256, 128, 689)])
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
# skinny kernel (the k=1 step at the har width); (512, 561, 128): the
# E²LM batch statistics at the har width
@pytest.mark.parametrize("m,k,n", [(33, 257, 129), (1, 561, 128), (3, 37, 19), (512, 561, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hidden_proj_kernel_matches_plain(cuda, m, k, n, dtype):
    x, a = _randn(cuda, (m, k), dtype, 1), _randn(cuda, (k, n), dtype, 2)
    b = _randn(cuda, (n,), dtype, 3)
    before = launch_counts()["hidden_proj"]
    hidden_proj(x, a, b, activation="sigmoid")
    torch.cuda.synchronize()
    assert launch_counts()["hidden_proj"] == before + 1
    assert _proj_err(x, a, b, "sigmoid") <= 1e-6


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


# (128, 128): P, the 16-byte path; (128, 561): β, the scalar path;
# (33, 257): ragged
@pytest.mark.parametrize("n1,n2", [(128, 128), (128, 561), (33, 257)])
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


@pytest.mark.parametrize("activation,forget", [("identity", 1.0), ("sigmoid", 0.97)])
def test_k1_step_and_batch_statistics_on_the_kernels(cuda, activation, forget):
    """One k=1 step at the har width launches hidden_proj, matmul_atb and
    rank1_add twice and agrees with the plain composition; the batch
    statistics launch hidden_proj once and matmul_atb twice."""
    state = _fleet(cuda, activation, forget, d=1, n=561, nh=128)
    state = state.replace(beta=state.beta[0], p=state.p[0])
    x = torch.rand(561, generator=torch.Generator().manual_seed(0)).to(cuda)
    before = launch_counts()
    got = oselm_step_k1_kernel(state, x, x)
    torch.cuda.synchronize()
    after = launch_counts()
    assert [after[k] - before[k] for k in ("hidden_proj", "matmul_atb", "rank1_add")] == [1, 1, 2]
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


# (13, 10, 37): hops 1, 2 and 6 (2·hops+1 = D); the har width at hops 2
@pytest.mark.parametrize("d,r,c,hops", [(13, 10, 37, 1), (13, 10, 37, 2), (13, 10, 37, 6),
                                        (256, 128, 689, 2)])
def test_banded_mix_kernel_is_bit_exact_with_plain(cuda, d, r, c, hops):
    x = torch.from_numpy(
        np.random.default_rng(23).standard_normal((d, r, c)).astype(np.float32)).to(cuda)
    got = _launched("banded_mix", lambda: banded_mix(x, hops))
    assert torch.equal(got, banded_mix_plain(x, hops))


def test_mix_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((5, 4, 9), device=cuda)
    with pytest.raises(ValueError, match="band"):
        banded_mix(x, 3)
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


@pytest.mark.parametrize("b,s,h,dk,dv", [(2, 33, 3, 16, 8), (2, 200, 3, 16, 64),
                                         (4, 1000, 25, 16, 64), (4, 2048, 25, 16, 64),
                                         (1, 300, 2, 64, 65),
                                         (1, 1, 2, 16, 64)])
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


def test_attention_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="head widths"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="must be"):
        flash_attention(q, q.bfloat16(), q.bfloat16())
    shifted = torch.zeros(1 * 8 * 2 * 64 + 1, device=cuda, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte boundary"):
        qb = shifted.view(1, 8, 2, 64)  # contiguous, 2 bytes into its storage
        flash_attention(qb, qb, qb)
    with pytest.raises(ValueError, match="contiguous"):
        gla_forward(q[..., :16], q[..., :16], q, torch.zeros(1, 8, 2, device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 128, 1, 256, device=cuda)
        gla_forward(big, big, big, torch.zeros(1, 128, 1, device=cuda))


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
