"""Eq. 8 merge kernels; port of ``repro.kernels.topology_merge``.

- ``masked_segment_sum_mix`` — out[c] = Σ_{cid[d]=c} mask[d]·w[d] over the
  stacked payloads w = [U | V] (star, hierarchical), and
  ``segment_sum_mix``, the same sums with no mask;
- ``segment_broadcast`` — out[d] = sums[cid[d]], each device's cluster sum
  gathered back;
- ``banded_mix`` — the open ring's neighbour sum
  out[d] = Σ_{o=−hops..hops} x[(d+o) mod D];
- ``from_uv_solve`` — Gauss-Jordan without pivoting on [U+εI | I | V],
  giving P = (U+εI)⁻¹ and β = PV per system;
- ``banded_merge_solve`` — the open ring: each device sums its 2·hops+1
  neighbour payloads and solves, in one kernel (``from_uv_solve``'s, the
  band summed as it is loaded);
- ``dense_mix`` — out = M @ flatten(x) for any (D, D) mask, the route of a
  dense topology that is not fully connected;
- ``topology_mix`` — ``Topology.mix`` on these kernels, with the
  reference's dispatch.

Each wrapper takes its plain PyTorch version for CPU tensors and launches
the CUDA kernel of ``csrc/topology_merge.cu`` for CUDA tensors, or raises.
The plain versions keep the reference's arithmetic (the elimination step
of ``_gj_sweep``, the neighbour order of ``_banded_solve_kernel`` and the
accumulation order of ``_segsum_kernel`` and ``_banded_kernel``: from zero,
members in ascending device order, neighbours from −hops to +hops);
``dense_mix_plain`` keeps the kernel's: one fused multiply-add per
device k, in increasing k.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import _lib

__all__ = [
    "banded_merge_solve",
    "banded_merge_solve_plain",
    "banded_mix",
    "banded_mix_plain",
    "dense_mix",
    "dense_mix_plain",
    "from_uv_solve",
    "from_uv_solve_plain",
    "masked_segment_sum_mix",
    "masked_segment_sum_mix_plain",
    "segment_broadcast",
    "segment_broadcast_plain",
    "segment_sum_mix",
    "segment_sum_mix_plain",
    "topology_mix",
]


# ------------------------------------------------------------ segment sums


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


def _device_ints(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def _segment_sum_plain(w, cluster_ids, n_clusters, mask, kernel):
    starts = _segment_starts(cluster_ids, w.shape[0], n_clusters, kernel)
    out = torch.zeros((n_clusters,) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)
    mf = None if mask is None else mask.to(w.dtype)
    for c in range(n_clusters):
        for d in range(int(starts[c]), int(starts[c + 1])):
            out[c] += w[d] if mf is None else w[d] * mf[d]
    return out


def _segment_sum(w, cluster_ids, n_clusters, mask, kernel):
    """Launch the segment-sum kernel, masked when ``mask`` is given."""
    if mask is None:
        _lib.require_cuda_f32(kernel, w=w)
    else:
        mask = mask.to(torch.float32).contiguous()
        _lib.require_cuda_f32(kernel, w=w, mask=mask)
        if mask.shape != (w.shape[0],):
            raise ValueError(f"mask must be ({w.shape[0]},); got {tuple(mask.shape)}")
    starts = _device_ints(_segment_starts(cluster_ids, w.shape[0], n_clusters, kernel), w.device)
    out = torch.empty((n_clusters,) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)
    elems = w[0].numel() if w.shape[0] else 0
    lib = _lib.library()
    if mask is None:
        status = lib.repro_segment_sum(w.data_ptr(), starts.data_ptr(), out.data_ptr(),
                                       n_clusters, elems, _lib.stream())
    else:
        status = lib.repro_masked_segment_sum(w.data_ptr(), starts.data_ptr(), mask.data_ptr(),
                                              out.data_ptr(), n_clusters, elems, _lib.stream())
    _lib.check(status, kernel)
    _lib.count_launch(kernel)
    return out


def masked_segment_sum_mix_plain(
    w: torch.Tensor, cluster_ids, mask: torch.Tensor, n_clusters: int
) -> torch.Tensor:
    return _segment_sum_plain(w, cluster_ids, n_clusters, mask, "masked_segment_sum_mix")


def masked_segment_sum_mix(
    w: torch.Tensor, cluster_ids, mask: torch.Tensor, n_clusters: int
) -> torch.Tensor:
    """Participation-masked cluster sums (C, R, Cc) of w (D, R, Cc);
    members are summed in ascending device order."""
    if w.device.type == "cpu":
        return masked_segment_sum_mix_plain(w, cluster_ids, mask, n_clusters)
    return _segment_sum(w, cluster_ids, n_clusters, mask, "masked_segment_sum_mix")


def segment_sum_mix_plain(w: torch.Tensor, cluster_ids, n_clusters: int) -> torch.Tensor:
    return _segment_sum_plain(w, cluster_ids, n_clusters, None, "segment_sum_mix")


def segment_sum_mix(w: torch.Tensor, cluster_ids, n_clusters: int) -> torch.Tensor:
    """Cluster sums (C, R, Cc) of w (D, R, Cc) over sorted ``cluster_ids``;
    each cluster's members are summed from zero in ascending device order."""
    if w.device.type == "cpu":
        return segment_sum_mix_plain(w, cluster_ids, n_clusters)
    return _segment_sum(w, cluster_ids, n_clusters, None, "segment_sum_mix")


def _broadcast_ids(cluster_ids, n_clusters: int) -> np.ndarray:
    cids = np.asarray(cluster_ids)
    if cids.ndim != 1:
        raise ValueError(f"cluster_ids must be (D,); got {cids.shape}")
    if cids.size and (cids.min() < 0 or cids.max() >= n_clusters):
        raise ValueError(f"cluster ids must lie in [0, {n_clusters})")
    return cids


def segment_broadcast_plain(sums: torch.Tensor, cluster_ids) -> torch.Tensor:
    cids = _broadcast_ids(cluster_ids, sums.shape[0])
    return sums[torch.as_tensor(cids, dtype=torch.long, device=sums.device)]


def segment_broadcast(sums: torch.Tensor, cluster_ids) -> torch.Tensor:
    """Each device's cluster sum gathered back: out[d] = sums[cid[d]],
    (C, R, Cc) → (D, R, Cc)."""
    if sums.device.type == "cpu":
        return segment_broadcast_plain(sums, cluster_ids)
    _lib.require_cuda_f32("segment_broadcast", sums=sums)
    cids = _device_ints(_broadcast_ids(cluster_ids, sums.shape[0]), sums.device)
    d = cids.shape[0]
    out = torch.empty((d,) + tuple(sums.shape[1:]), dtype=sums.dtype, device=sums.device)
    elems = sums[0].numel() if sums.shape[0] else 0
    status = _lib.library().repro_segment_broadcast(
        sums.data_ptr(), cids.data_ptr(), out.data_ptr(), d, elems, _lib.stream(),
    )
    _lib.check(status, "segment_broadcast")
    _lib.count_launch("segment_broadcast")
    return out


# ------------------------------------------------------ Gauss-Jordan solve


def _gj_solve_plain(a: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[A | I | V] → [I | A⁻¹ | A⁻¹V] by the reference's elimination
    (``_gj_sweep``): row_k = w[k]/w[k,k]; w ← w − (w[:,k] − e_k)·row_k.
    The update is one fused multiply-add, rounded once (``_fma``), as XLA
    and nvcc both contract it."""
    s, n, _ = a.shape
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    w = torch.cat([a, eye.expand(s, n, n), v], dim=2)
    for k in range(n):
        row_k = w[:, k : k + 1, :] / w[:, k : k + 1, k : k + 1]
        col_k = w[:, :, k : k + 1] - eye[:, k : k + 1]
        w = _fma(-col_k, row_k, w)
    return w[:, :, n : 2 * n], w[:, :, 2 * n :]


# the 29 bits an f32 significand drops from an f64 one, and their midpoint
_F32_DROPPED, _F32_HALF = (1 << 29) - 1, 1 << 28


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c in f32 with a single rounding (a fused multiply-add). The
    product of two f32 values is exact in f64, so their f64 sum converts to
    the f32 the exact sum rounds to, except where that sum is inexact and
    lands on a midpoint between two f32 values (or in the f32 subnormal
    range, where fewer bits are kept). Only there is the sum rounded to
    odd: where its error (TwoSum) is not 0 and its last bit is even, it
    moves to its neighbour on the error's side. A value rounded to odd at
    53 bits rounds to 24 bits as the exact sum does (Boldo and
    Melquiond), so the conversion to f32 rounds once."""
    s = torch.addcmul(c.double(), a.double(), b.double())
    risky = (s.view(torch.int64) & _F32_DROPPED) == _F32_HALF
    mag = s.abs()
    risky |= (mag < 2.0**-126) & (mag != 0)
    if bool(risky.any()):
        at = risky.nonzero(as_tuple=True)  # found once for the four gathers
        ar, br, cr = (x.expand(s.shape)[at].double() for x in (a, b, c))
        prod, t = ar * br, s[at]
        bv = t - prod
        err = (prod - (t - bv)) + (cr - bv)
        even = (t.view(torch.int64) & 1) == 0
        toward = torch.copysign(torch.full_like(t, math.inf), err)
        s.index_put_(at, torch.where((err != 0) & even, torch.nextafter(t, toward), t))
    return s.to(c.dtype)


def from_uv_solve_plain(
    u: torch.Tensor, v: torch.Tensor, *, ridge: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor]:
    n = u.shape[-1]
    a = u + ridge * torch.eye(n, dtype=u.dtype, device=u.device)
    return _gj_solve_plain(a, v)


def _solve_workspace(s: int, n: int, m: int, device: torch.device) -> torch.Tensor | None:
    """The wide solve's workspace (past Ñ = 320), or None where the
    cluster solve needs none."""
    return _lib.workspace(_lib.library().repro_uv_solve_ws(s, n, m), device)


def from_uv_solve(
    u: torch.Tensor, v: torch.Tensor, *, ridge: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched §4.2 step 5: u (S, Ñ, Ñ), v (S, Ñ, m) → P = (U+εI)⁻¹,
    β = PV. On CUDA, u and v may be column slices of one packed [U | V]
    (unit column stride); the outputs are contiguous. The kernel holds
    each system in one thread-block cluster and eliminates it once, or,
    past Ñ = 320, eliminates it in panels of 32 pivots in global memory."""
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
    p = torch.empty((s, n, n), dtype=torch.float32, device=u.device)
    beta = torch.empty((s, n, m), dtype=torch.float32, device=u.device)
    ws = _solve_workspace(s, n, m, u.device)
    status = _lib.library().repro_uv_solve(
        u.data_ptr(), u.stride(0), u.stride(1), v.data_ptr(), v.stride(0), v.stride(1),
        p.data_ptr(), beta.data_ptr(), s, n, m, float(ridge), _lib.ptr(ws), _lib.stream(),
    )
    _lib.check(status, "from_uv_solve")
    _lib.count_launch("from_uv_solve")
    return p, beta


# ------------------------------------------------- fused banded merge+solve


def _check_band(d: int, hops: int) -> None:
    if 2 * hops + 1 > d:
        raise ValueError(f"band 2*{hops}+1 exceeds n_devices={d}; use a full-sum path")


def banded_mix_plain(x: torch.Tensor, hops: int) -> torch.Tensor:
    _check_band(x.shape[0], hops)
    acc = torch.zeros_like(x)
    for o in range(-hops, hops + 1):  # device d adds x[(d+o) mod D]
        acc = acc + torch.roll(x, -o, dims=0)
    return acc


def banded_mix(x: torch.Tensor, hops: int) -> torch.Tensor:
    """Circular banded neighbour sum out[d] = Σ_{o=−hops..hops} x[(d+o) mod D]
    over a stacked (D, R, C) array, summed from zero for o = −hops..+hops.
    Needs 2·hops+1 ≤ D: a wider band would count a device twice."""
    if x.ndim != 3:
        raise ValueError(f"need x (D, R, C); got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return banded_mix_plain(x, hops)
    _lib.require_cuda_f32("banded_mix", x=x)
    d = x.shape[0]
    _check_band(d, hops)
    out = torch.empty_like(x)
    status = _lib.library().repro_banded_mix(
        x.data_ptr(), out.data_ptr(), d, x[0].numel() if d else 0, hops, _lib.stream(),
    )
    _lib.check(status, "banded_mix")
    _lib.count_launch("banded_mix")
    return out


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
    per-device P (D, Ñ, Ñ), β (D, Ñ, m) of the ±hops neighbour sum. The
    kernel is ``from_uv_solve``'s, its loader summing each device's band
    as it reads it."""
    if w.ndim != 3 or w.shape[2] <= w.shape[1]:
        raise ValueError(f"need w (D, Ñ, Ñ+m); got {tuple(w.shape)}")
    if w.device.type == "cpu":
        return banded_merge_solve_plain(w, hops, ridge=ridge)
    _lib.require_cuda_f32("banded_merge_solve", w=w)
    d, n, nm = w.shape
    _check_band(d, hops)
    m = nm - n
    p = torch.empty((d, n, n), dtype=torch.float32, device=w.device)
    beta = torch.empty((d, n, m), dtype=torch.float32, device=w.device)
    ws = _solve_workspace(d, n, m, w.device)
    status = _lib.library().repro_banded_merge_solve(
        w.data_ptr(), p.data_ptr(), beta.data_ptr(), d, n, m, hops, float(ridge), _lib.ptr(ws),
        _lib.stream(),
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
    mt = torch.empty_like(m)  # the kernel's scratch copy of Mᵀ
    status = _lib.library().repro_dense_mix(
        m.data_ptr(), mt.data_ptr(), x.data_ptr(), out.data_ptr(), d, f, _lib.stream(),
    )
    _lib.check(status, "dense_mix")
    _lib.count_launch("dense_mix")
    return out


# ------------------------------------------------------------- dispatch


def topology_mix(x: torch.Tensor, topology) -> torch.Tensor:
    """``Topology.mix`` on the kernels, with the reference's dispatch: a
    segment topology sums its clusters (``segment_sum_mix``), then either
    exchanges heads (one sum, broadcast) or gathers each cluster's sum back
    (``segment_broadcast``); a closed band is one sum, broadcast; an open
    band is ``banded_mix``; any other mask is ``dense_mix``. The broadcast
    results are expanded views of one (1, R, C) sum."""
    if topology.kind == "segment":
        sums = segment_sum_mix(x, topology.cluster_ids, topology.n_clusters)
        if topology.head_exchange:
            return sums.sum(0, keepdim=True).expand(x.shape)
        return segment_broadcast(sums, topology.cluster_ids)
    if topology.kind == "banded":
        if topology.band_closed:
            return x.sum(0, keepdim=True).expand(x.shape)
        return banded_mix(x, topology.hops)
    return dense_mix(x, topology.dense_matrix())
