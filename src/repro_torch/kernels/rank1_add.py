"""Rank-1 update O = X + s·u vᵀ, the two updates of the k=1 OS-ELM step;
port of ``repro.kernels.rank1_add``.

- ``rank1_add`` — one target, the counterpart of the TPU kernel. The scale
  is a float or a one-element f32 tensor on X's device, which the kernel
  reads from device memory.
- ``k1_update`` — the k=1 step's whole tail after ph = P·h, in one launch
  of the same kernel source: denom = 1 + h·ph, err = t − hᵀβ, and both
  rank-1 updates, P' = P + (−1/denom)·ph phᵀ and β' = β + (1/denom)·ph errᵀ.

Each wrapper takes its plain version for CPU tensors and launches the
kernel of ``csrc/rank1_add.cu`` for CUDA tensors, or raises. Both versions
round the updates as the reference does as XLA compiles it (its
interpret-mode kernel, bit for bit): the scale rounded to f32, the
product s·u rounded, then one fused multiply-add with v and X. The plain
version takes the fused rounding through f64, where (s·u)·v is exact.
``k1_update_plain`` sums h·ph and hᵀβ in the kernel's fixed order
(``lane_sum``) and takes −1/denom and 1/denom as IEEE divisions, so the
two agree bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _lib
from repro_torch.kernels.topology_merge import _fma

__all__ = ["k1_update", "k1_update_plain", "lane_sum", "rank1_add", "rank1_add_plain"]

LANES = 32  # a warp: the kernel's reductions end in a 32-lane butterfly


def _check(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> None:
    if x.ndim != 2 or u.shape != (x.shape[0],) or v.shape != (x.shape[1],):
        raise ValueError(f"rank1_add: x {tuple(x.shape)}, u {tuple(u.shape)} and v "
                         f"{tuple(v.shape)} must be (N1, N2), (N1,) and (N2,)")


def rank1_add_plain(
    x: torch.Tensor, u: torch.Tensor, v: torch.Tensor, scale: torch.Tensor | float
) -> torch.Tensor:
    _check(x, u, v)
    su = torch.as_tensor(scale, dtype=torch.float32, device=x.device) * u.float()
    return _fma(su[:, None], v.float()[None, :], x.float())


def rank1_add(
    x: torch.Tensor, u: torch.Tensor, v: torch.Tensor, scale: torch.Tensor | float
) -> torch.Tensor:
    """O = X + scale·u vᵀ for X (N1, N2), u (N1,), v (N2,) → f32."""
    if x.device.type == "cpu":
        return rank1_add_plain(x, u, v, scale)
    _check(x, u, v)
    bf16 = _lib.require_cuda_f32_or_bf16("rank1_add", x=x, u=u, v=v)
    if isinstance(scale, torch.Tensor):
        if scale.numel() != 1:
            raise ValueError(f"rank1_add: scale must hold one value; got {tuple(scale.shape)}")
        _lib.require_cuda_f32("rank1_add", scale=scale)
        if scale.device != x.device:
            raise ValueError(f"rank1_add: scale is on {scale.device}, x on {x.device}")
        s_ptr, s_val = scale.data_ptr(), 0.0
    else:
        s_ptr, s_val = None, float(scale)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    n1, n2 = x.shape
    status = _lib.library().repro_rank1_add(
        x.data_ptr(), u.data_ptr(), v.data_ptr(), s_ptr, s_val, out.data_ptr(), n1, n2, bf16,
        _lib.stream(),
    )
    _lib.check(status, "rank1_add")
    _lib.count_launch("rank1_add")
    return out


def lane_sum(prods: torch.Tensor) -> torch.Tensor:
    """Σ over dim 0 of ``prods`` (n, ...) in the kernel's order: lane l
    adds rows l, l + 32, ... (rows past n as zeros, up to a multiple of 32)
    from zero, in order; then the 32 lanes' sums are halved pairwise
    (s_i + s_{i+16}, then + s_{i+8}, ...), the pairs a warp's xor-butterfly
    makes."""
    n = prods.shape[0]
    rows = -(-n // LANES) * LANES
    pad = (0, 0) * (prods.ndim - 1) + (0, rows - n)
    x = F.pad(prods, pad).reshape((rows // LANES, LANES) + tuple(prods.shape[1:]))
    s = torch.zeros_like(x[0])
    for r in range(x.shape[0]):
        s = s + x[r]
    while s.shape[0] > 1:
        half = s.shape[0] // 2
        s = s[:half] + s[half:]
    return s[0]


def _k1_check(p, beta, h, ph, t) -> None:
    n, m = beta.shape if beta.ndim == 2 else (-1, -1)
    if (beta.ndim != 2 or tuple(p.shape) != (n, n) or tuple(h.shape) != (n,)
            or tuple(ph.shape) != (n,) or tuple(t.shape) != (m,)):
        raise ValueError(f"k1_update: p {tuple(p.shape)}, beta {tuple(beta.shape)}, h "
                         f"{tuple(h.shape)}, ph {tuple(ph.shape)} and t {tuple(t.shape)} must "
                         "be (Ñ, Ñ), (Ñ, m), (Ñ,), (Ñ,) and (m,)")


def k1_update_plain(
    p: torch.Tensor, beta: torch.Tensor, h: torch.Tensor, ph: torch.Tensor, t: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    _k1_check(p, beta, h, ph, t)
    denom = 1.0 + lane_sum(h * ph)
    err = t - lane_sum(h[:, None] * beta)
    one = torch.ones_like(denom)
    return (rank1_add_plain(p, ph, ph, -one / denom),
            rank1_add_plain(beta, ph, err, one / denom))


def k1_update(
    p: torch.Tensor, beta: torch.Tensor, h: torch.Tensor, ph: torch.Tensor, t: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The k=1 step after ph = P·h, for P (Ñ, Ñ) already divided by λ, β
    (Ñ, m), h and ph (Ñ,) and the target t (m,): (P', β') with denom =
    1 + h·ph, err = t − hᵀβ, P' = P − ph phᵀ/denom and β' = β + ph errᵀ/denom,
    each update one rounded product and one fused multiply-add."""
    if p.device.type == "cpu":
        return k1_update_plain(p, beta, h, ph, t)
    _k1_check(p, beta, h, ph, t)
    _lib.require_cuda_f32("k1_update", p=p, beta=beta, h=h, ph=ph, t=t)
    n, m = beta.shape
    p_out = torch.empty_like(p)
    beta_out = torch.empty_like(beta)
    status = _lib.library().repro_k1_update(
        p.data_ptr(), beta.data_ptr(), h.data_ptr(), ph.data_ptr(), t.data_ptr(),
        p_out.data_ptr(), beta_out.data_ptr(), n, m, _lib.stream(),
    )
    _lib.check(status, "rank1_add")
    _lib.count_launch("rank1_add")
    return p_out, beta_out
