"""Rank-1 update O = X + s·u vᵀ, the two updates of the k=1 OS-ELM step;
port of ``repro.kernels.rank1_add``.

``rank1_add`` takes ``rank1_add_plain`` for CPU tensors and launches the
kernel of ``csrc/rank1_add.cu`` for CUDA tensors, or raises. The scale is
a float or a one-element f32 tensor on X's device; the kernel reads a
tensor scale from device memory, so the k=1 step never waits on the card
for its −1/denom and 1/denom.

Both versions round as the reference does as XLA compiles it (its
interpret-mode kernel, bit for bit): the scale rounded to f32, the
product s·u rounded, then one fused multiply-add with v and X. The plain
version takes the fused rounding through f64, where (s·u)·v is exact.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.topology_merge import _fma

__all__ = ["rank1_add", "rank1_add_plain"]


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
