"""Masked Eq. 8 merge kernels; port of the masked-merge half of
``repro.kernels.topology_merge``.

- ``masked_segment_sum_mix`` — out[c] = Σ_{cid[d]=c} mask[d]·w[d] over the
  stacked payloads w = [U | V] (star, hierarchical);
- ``from_uv_solve`` — Gauss-Jordan without pivoting on [U+εI | I | V],
  giving P = (U+εI)⁻¹ and β = PV per system;
- ``banded_merge_solve`` — the open ring: each device sums its 2·hops+1
  neighbour payloads and solves, in one kernel;
- ``dense_mix`` — out = M @ flatten(x) for any (D, D) mask, the route of a
  dense topology that is not fully connected.

Each wrapper takes its plain PyTorch version for CPU tensors and launches
the CUDA kernel of ``csrc/topology_merge.cu`` for CUDA tensors, or raises.
The plain versions keep the reference's arithmetic (the elimination step
of ``_gj_sweep`` and the neighbour order of ``_banded_solve_kernel``);
``dense_mix_plain`` keeps the kernel's: one fused multiply-add per
device k, in increasing k.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _lib

__all__ = [
    "banded_merge_solve",
    "banded_merge_solve_plain",
    "dense_mix",
    "dense_mix_plain",
    "from_uv_solve",
    "from_uv_solve_plain",
    "masked_segment_sum_mix",
    "masked_segment_sum_mix_plain",
]


# ------------------------------------------------------ masked segment sum


def _segment_starts(
    cluster_ids, n_devices: int, n_clusters: int, kernel: str = "masked_segment_sum_mix"
) -> np.ndarray:
    """(C+1,) offsets of each cluster's run of devices; the ids must be
    sorted so that each cluster is one contiguous run."""
    cids = np.asarray(cluster_ids)
    if cids.shape != (n_devices,):
        raise ValueError(f"cluster_ids must be ({n_devices},); got {cids.shape}")
    if not np.all(np.diff(cids) >= 0):
        raise ValueError(
            f"{kernel} needs sorted (contiguous-cluster) cluster_ids; "
            "sort the device axis by cluster first"
        )
    if cids.size and (cids[0] < 0 or cids[-1] >= n_clusters):
        raise ValueError(f"cluster ids must lie in [0, {n_clusters})")
    return np.searchsorted(cids, np.arange(n_clusters + 1), side="left").astype(np.int32)


def masked_segment_sum_mix_plain(
    w: torch.Tensor, cluster_ids, mask: torch.Tensor, n_clusters: int
) -> torch.Tensor:
    starts = _segment_starts(cluster_ids, w.shape[0], n_clusters)
    out = torch.zeros((n_clusters,) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)
    mf = mask.to(w.dtype)
    for c in range(n_clusters):
        for d in range(int(starts[c]), int(starts[c + 1])):
            out[c] += w[d] * mf[d]
    return out


def masked_segment_sum_mix(
    w: torch.Tensor, cluster_ids, mask: torch.Tensor, n_clusters: int
) -> torch.Tensor:
    """Participation-masked cluster sums (C, R, Cc) of w (D, R, Cc);
    members are summed in ascending device order."""
    if w.device.type == "cpu":
        return masked_segment_sum_mix_plain(w, cluster_ids, mask, n_clusters)
    mask = mask.to(torch.float32).contiguous()
    _lib.require_cuda_f32("masked_segment_sum_mix", w=w, mask=mask)
    if mask.shape != (w.shape[0],):
        raise ValueError(f"mask must be ({w.shape[0]},); got {tuple(mask.shape)}")
    starts = torch.from_numpy(_segment_starts(cluster_ids, w.shape[0], n_clusters))
    starts = starts.to(w.device)
    out = torch.empty((n_clusters,) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)
    elems = w[0].numel() if w.shape[0] else 0
    status = _lib.library().repro_masked_segment_sum(
        w.data_ptr(), starts.data_ptr(), mask.data_ptr(), out.data_ptr(),
        n_clusters, elems, _lib.stream(),
    )
    _lib.check(status, "masked_segment_sum_mix")
    _lib.count_launch("masked_segment_sum_mix")
    return out


# ------------------------------------------------------ Gauss-Jordan solve


def _gj_solve_plain(a: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[A | I | V] → [I | A⁻¹ | A⁻¹V] by the reference's elimination
    (``_gj_sweep``): row_k = w[k]/w[k,k]; w ← w − (w[:,k] − e_k)·row_k.
    The update is one fused multiply-add, rounded once, as XLA and nvcc
    both contract it; the f64 product of two f32 values is exact, so
    rounding the f64 result to f32 gives that fused result."""
    s, n, _ = a.shape
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    w = torch.cat([a, eye.expand(s, n, n), v], dim=2)
    for k in range(n):
        row_k = w[:, k : k + 1, :] / w[:, k : k + 1, k : k + 1]
        col_k = w[:, :, k : k + 1] - eye[:, k : k + 1]
        w = _fma(-col_k, row_k, w)
    return w[:, :, n : 2 * n], w[:, :, 2 * n :]


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c in f32 with a single rounding (a fused multiply-add)."""
    return (a.double() * b.double() + c.double()).to(c.dtype)


def from_uv_solve_plain(
    u: torch.Tensor, v: torch.Tensor, *, ridge: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor]:
    n = u.shape[-1]
    a = u + ridge * torch.eye(n, dtype=u.dtype, device=u.device)
    return _gj_solve_plain(a, v)


def _check_solve_n(kernel: str, n: int) -> None:
    if _lib.library().repro_solve_smem(n) > _lib.MAX_SMEM:
        raise ValueError(f"{kernel}: Ñ={n} does not fit the solve's shared-memory tile")


def from_uv_solve(
    u: torch.Tensor, v: torch.Tensor, *, ridge: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched §4.2 step 5: u (S, Ñ, Ñ), v (S, Ñ, m) → P = (U+εI)⁻¹,
    β = PV. On CUDA, u and v may be column slices of one packed [U | V]
    (unit column stride); the outputs are contiguous."""
    if u.ndim != 3 or v.ndim != 3 or u.shape[:2] != v.shape[:2] or u.shape[1] != u.shape[2]:
        raise ValueError(f"need u (S, Ñ, Ñ) and v (S, Ñ, m); got {tuple(u.shape)}, {tuple(v.shape)}")
    if u.device.type == "cpu":
        return from_uv_solve_plain(u, v, ridge=ridge)
    for name, t in (("u", u), ("v", v)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or t.stride(2) != 1:
            raise ValueError(
                f"from_uv_solve: {name} must be a float32 CUDA tensor with unit "
                f"column stride; got {t.dtype} on {t.device}, strides {t.stride()}"
            )
    s, n, m = v.shape
    _check_solve_n("from_uv_solve", n)
    p = torch.empty((s, n, n), dtype=torch.float32, device=u.device)
    beta = torch.empty((s, n, m), dtype=torch.float32, device=u.device)
    status = _lib.library().repro_uv_solve(
        u.data_ptr(), u.stride(0), u.stride(1), v.data_ptr(), v.stride(0), v.stride(1),
        p.data_ptr(), beta.data_ptr(), s, n, m, float(ridge), _lib.stream(),
    )
    _lib.check(status, "from_uv_solve")
    _lib.count_launch("from_uv_solve")
    return p, beta


# ------------------------------------------------- fused banded merge+solve


def _check_band(d: int, hops: int) -> None:
    if 2 * hops + 1 > d:
        raise ValueError(f"band 2*{hops}+1 exceeds n_devices={d}; use a full-sum path")


def banded_merge_solve_plain(
    w: torch.Tensor, hops: int, *, ridge: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor]:
    d, n, _ = w.shape
    _check_band(d, hops)
    wsum = torch.roll(w, hops, dims=0)  # device d sees (d − hops) first
    for o in range(-hops + 1, hops + 1):
        wsum = wsum + torch.roll(w, -o, dims=0)
    return from_uv_solve_plain(wsum[:, :, :n], wsum[:, :, n:], ridge=ridge)


def banded_merge_solve(
    w: torch.Tensor, hops: int, *, ridge: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused open-ring merge: w (D, Ñ, Ñ+m) stacked [U | V] payloads →
    per-device P (D, Ñ, Ñ), β (D, Ñ, m) of the ±hops neighbour sum."""
    if w.ndim != 3 or w.shape[2] <= w.shape[1]:
        raise ValueError(f"need w (D, Ñ, Ñ+m); got {tuple(w.shape)}")
    if w.device.type == "cpu":
        return banded_merge_solve_plain(w, hops, ridge=ridge)
    _lib.require_cuda_f32("banded_merge_solve", w=w)
    d, n, nm = w.shape
    _check_band(d, hops)
    _check_solve_n("banded_merge_solve", n)
    m = nm - n
    p = torch.empty((d, n, n), dtype=torch.float32, device=w.device)
    beta = torch.empty((d, n, m), dtype=torch.float32, device=w.device)
    status = _lib.library().repro_banded_merge_solve(
        w.data_ptr(), p.data_ptr(), beta.data_ptr(), d, n, m, hops, float(ridge), _lib.stream(),
    )
    _lib.check(status, "banded_merge_solve")
    _lib.count_launch("banded_merge_solve")
    return p, beta


# ------------------------------------------------------------- dense mix


def _dense_operands(x: torch.Tensor, matrix) -> tuple[torch.Tensor, torch.Tensor]:
    if x.ndim != 3:
        raise ValueError(f"need x (D, R, C); got {tuple(x.shape)}")
    d = x.shape[0]
    m = torch.as_tensor(matrix, dtype=torch.float32, device=x.device).contiguous()
    if tuple(m.shape) != (d, d):
        raise ValueError(f"matrix must be ({d}, {d}); got {tuple(m.shape)}")
    return x.reshape(d, -1), m


def dense_mix_plain(x: torch.Tensor, matrix) -> torch.Tensor:
    xf, m = _dense_operands(x, matrix)
    acc = torch.zeros_like(xf)
    for k in range(xf.shape[0]):
        acc = _fma(m[:, k : k + 1], xf[k : k + 1], acc)
    return acc.reshape(x.shape)


def dense_mix(x: torch.Tensor, matrix) -> torch.Tensor:
    """out[i] = Σ_k M[i, k]·x[k] over a stacked (D, R, C) payload, for any
    (D, D) mask M; each output element accumulates k = 0..D−1 in order,
    one fused multiply-add per step (exact for a 0/1 mask, where every
    product is exact)."""
    if x.device.type == "cpu":
        return dense_mix_plain(x, matrix)
    xf, m = _dense_operands(x, matrix)
    _lib.require_cuda_f32("dense_mix", x=x, matrix=m)
    d, f = xf.shape
    out = torch.empty_like(x)
    status = _lib.library().repro_dense_mix(
        m.data_ptr(), x.data_ptr(), out.data_ptr(), d, f, _lib.stream(),
    )
    _lib.check(status, "dense_mix")
    _lib.count_launch("dense_mix")
    return out
