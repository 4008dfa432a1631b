"""AᵀB with the sample axis contracted — the E²LM sufficient statistics
U = HᵀH, V = Hᵀt (Eq. 6) and the k=1 step's P·h; port of
``repro.kernels.matmul_atb``.

``matmul_atb`` takes ``matmul_atb_plain`` for CPU tensors and launches
the kernel of ``csrc/matmul_atb.cu`` for CUDA tensors, or raises. A reads
in place (Aᵀ is never materialised); leading axes batch independent
products, as a fleet's Eq. 13 boot needs. Operands are f32 or bf16 (both
of one type), the result f32. The kernel sums each output in a fixed order
of its own; the plain version is a PyTorch matrix product, so the two
agree to f32 rounding, not bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

__all__ = ["matmul_atb", "matmul_atb_plain", "uv_accum"]


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim < 2 or a.ndim != b.ndim or a.shape[:-1] != b.shape[:-1]:
        raise ValueError(f"matmul_atb: a {tuple(a.shape)} and b {tuple(b.shape)} must be "
                         "(..., K, N1) and (..., K, N2) with the same leading axes")


def matmul_atb_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, b)
    return a.float().transpose(-1, -2) @ b.float()


def matmul_atb(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """AᵀB for a (..., K, N1), b (..., K, N2) → (..., N1, N2) f32."""
    if a.device.type == "cpu":
        return matmul_atb_plain(a, b)
    _check(a, b)
    bf16 = _lib.require_cuda_f32_or_bf16("matmul_atb", a=a, b=b)
    k, n1, n2 = a.shape[-2], a.shape[-1], b.shape[-1]
    out = torch.empty(a.shape[:-2] + (n1, n2), dtype=torch.float32, device=a.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    batch = a.numel() // (k * n1)
    status = _lib.library().repro_matmul_atb(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, k, n1, n2, bf16, _lib.stream(),
    )
    _lib.check(status, "matmul_atb")
    _lib.count_launch("matmul_atb")
    return out


def uv_accum(h: torch.Tensor, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """U = HᵀH, V = Hᵀt (the paper's Eq. 6 intermediates), one product each."""
    return matmul_atb(h, h), matmul_atb(h, t)
