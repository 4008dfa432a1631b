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
``quantize_pack`` is held bit for bit: its arithmetic has no order to
differ in.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SLFNParams, init_oselm
from repro_torch.kernels import (
    banded_merge_solve,
    banded_merge_solve_plain,
    fleet_ingest,
    fleet_ingest_plain,
    from_uv_solve,
    from_uv_solve_plain,
    launch_counts,
    masked_segment_sum_mix,
    masked_segment_sum_mix_plain,
    quantize_pack,
    quantize_pack_plain,
)

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
