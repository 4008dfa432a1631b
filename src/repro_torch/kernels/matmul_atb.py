"""AᵀB with the sample axis contracted — the E²LM sufficient statistics
U = HᵀH, V = Hᵀt (Eq. 6) and the k=1 step's P·h; port of
``repro.kernels.matmul_atb``.

``matmul_atb`` takes ``matmul_atb_plain`` for CPU tensors and launches
the kernel of ``csrc/matmul_atb.cu`` for CUDA tensors, or raises. A reads
in place (Aᵀ is never materialised); leading axes batch independent
products, as a fleet's Eq. 13 boot needs. Operands are f32 or bf16 (both
of one type; other types and mixes are cast to f32, as ``_lib.operands``
says), the result f32. The kernel sums each output in a fixed order of
its own; the plain version is a PyTorch matrix product, so the two
agree to f32 rounding, not bit for bit. ``split_plan`` cuts the sample
axis into the slices the kernel sums side by side (one block per output
tile and slice, then the slices added in order).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

__all__ = ["matmul_atb", "matmul_atb_plain", "split_plan", "uv_accum"]

SKINNY_ROWS = 4         # N1 up to this takes gemm.cuh's skinny kernel (kSkinnyRows)
TILE = (32, 64)         # the split kernel's output tile (SBM, SBN)
STEP = 16               # samples a stage of the split kernel (SBK)
MIN_SLICE = 64          # samples in the shortest slice
TARGET_BLOCKS = 2 * 132  # about two blocks on each of an H100's SMs


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim < 2 or a.ndim != b.ndim or a.shape[:-1] != b.shape[:-1]:
        raise ValueError(f"matmul_atb: a {tuple(a.shape)} and b {tuple(b.shape)} must be "
                         "(..., K, N1) and (..., K, N2) with the same leading axes")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(batch: int, k: int, n1: int, n2: int) -> tuple[int, int, int]:
    """(samples a slice, slices, workspace elements) of the kernel for
    ``batch`` products of (k, n1)ᵀ·(k, n2). Slices hold a multiple of 16
    samples, at least 64, and are as many as bring the grid to about
    TARGET_BLOCKS blocks; slice s covers samples [s·L, min((s+1)·L, k)). One
    slice needs no workspace; the skinny path (n1 ≤ 4) never splits.
    ``hidden_proj`` plans x (n1, k)·α (k, n2) with the same function: the
    two share the split kernel's body and its tile, and its n1 ≤ 4 rows
    take its own k=1 kernel."""
    if n1 <= SKINNY_ROWS or k <= 0:
        return max(k, 0), 1, 0
    tiles = batch * _cdiv(n1, TILE[0]) * _cdiv(n2, TILE[1])
    slices = max(1, min(_cdiv(k, MIN_SLICE), _cdiv(TARGET_BLOCKS, tiles)))
    length = _cdiv(_cdiv(k, slices), STEP) * STEP
    slices = _cdiv(k, length)
    return length, slices, (batch * slices * n1 * n2 if slices > 1 else 0)


def matmul_atb_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, b)
    return a.float().transpose(-1, -2) @ b.float()


def matmul_atb(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """AᵀB for a (..., K, N1), b (..., K, N2) → (..., N1, N2) f32."""
    if a.device.type == "cpu":
        return matmul_atb_plain(a, b)
    _check(a, b)
    a, b = _lib.operands("matmul_atb", _lib.F32_BF16, a=a, b=b)
    bf16 = int(a.dtype == torch.bfloat16)
    k, n1, n2 = a.shape[-2], a.shape[-1], b.shape[-1]
    out = torch.empty(a.shape[:-2] + (n1, n2), dtype=torch.float32, device=a.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    batch = a.numel() // (k * n1)
    length, slices, ws_numel = split_plan(batch, k, n1, n2)
    ws = torch.empty(ws_numel, dtype=torch.float32, device=a.device) if ws_numel else None
    status = _lib.library().repro_matmul_atb(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), 0 if ws is None else ws.data_ptr(), batch, k,
        n1, n2, length, slices, bf16, _lib.stream(),
    )
    _lib.check(status, "matmul_atb")
    _lib.count_launch("matmul_atb")
    return out


def uv_accum(h: torch.Tensor, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """U = HᵀH, V = Hᵀt (the paper's Eq. 6 intermediates), one product each."""
    return matmul_atb(h, h), matmul_atb(h, t)
