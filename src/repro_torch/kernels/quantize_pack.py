"""Per-tile int8 codec of the merge payloads and its fused publish kernel;
port of ``repro.kernels.quantize_pack`` and of the tile codec of
``repro.fleet.quantize``.

The payload is the stacked w = [U | V] of shape (D, Ñ, Ñ+m), cut into
``TILE_COLS``-wide column tiles; each (device, tile) is quantized against
its own absolute maximum. ``quantize_pack`` runs the whole publish step
of a device in one pass: pack [U | V], add the error-feedback residual,
and per tile take amax → scale (1.0 on an all-zero tile) → int8 codes
clip(rint(x/scale), ±127) → new residual x − q·scale, in f32 (operands
of other floating types are cast to it, as ``_lib.operands`` says). For
CPU tensors it takes ``quantize_pack_plain``; for CUDA tensors it
launches the kernel of ``csrc/quantize_pack.cu`` or raises.

Both are bit-exact with the reference (``quantize_pack`` and
``quantize_pack_xla``) as XLA compiles it: one f32 add for x; the scale
amax·fl(1/127), because XLA rewrites the division by the constant 127
into a product with its rounded reciprocal; an IEEE division x/scale;
round half to even; a NaN-propagating amax (a tile with a NaN gets scale
1.0 and the NaN's code is 0); and the residual rounded once, as XLA
contracts x − q·scale into a fused multiply-add. The plain version takes
that fused rounding through f64, where q·scale (7 by 24 bits) and the
nearly cancelling sum are exact.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _lib
from repro_torch.kernels.topology_merge import _fma

__all__ = [
    "TILE_COLS",
    "dequantize_tiles",
    "n_col_tiles",
    "quantize_pack",
    "quantize_pack_plain",
    "quantize_residual",
    "quantize_tiles",
]

TILE_COLS = 128          # one scale per (device, 128-column) payload tile
INT8_MAX = 127.0
INV_INT8_MAX = float(np.float32(1.0) / np.float32(INT8_MAX))  # fl(1/127) in f32


def n_col_tiles(n_cols: int) -> int:
    """Number of quantization tiles (= per-payload scales) of a payload
    with ``n_cols`` columns."""
    return -(-n_cols // TILE_COLS)


def _tiles(x: torch.Tensor) -> torch.Tensor:
    """(D, R, C) → (D, R, nt, TILE_COLS), the last tile zero-padded."""
    d, r, c = x.shape
    nt = n_col_tiles(c)
    return F.pad(x, (0, nt * TILE_COLS - c)).reshape(d, r, nt, TILE_COLS)


def _untile(xt: torch.Tensor, c: int) -> torch.Tensor:
    d, r, nt, _ = xt.shape
    return xt.reshape(d, r, nt * TILE_COLS)[:, :, :c]


def quantize_tiles(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tile int8 quantization of a stacked (D, R, C) payload:
    int8 codes of the input's shape and f32 scales (D, ceil(C/TILE_COLS)).
    An all-zero tile gets scale 1.0 (codes 0) rather than a 0-divide."""
    xt = _tiles(x)
    amax = xt.abs().amax(dim=(1, 3))  # NaN-propagating, as jnp.max
    scales = torch.where(amax > 0, amax * INV_INT8_MAX, torch.ones_like(amax))
    q = torch.round(xt / scales[:, None, :, None]).clamp(-INT8_MAX, INT8_MAX)
    return _untile(torch.nan_to_num(q, nan=0.0), x.shape[2]).to(torch.int8), scales


def dequantize_tiles(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_tiles``: int8 codes (D, R, C) + scales (D, nt)
    → the f32 payload (D, R, C), each value one rounded product q·scale."""
    out = _tiles(codes.to(torch.float32)) * scales[:, None, :, None]
    return _untile(out, codes.shape[2])


def quantize_residual(
    x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor
) -> torch.Tensor:
    """The error-feedback residual x − q·scale, rounded once."""
    qt = _tiles(codes.to(torch.float32))
    return _untile(_fma(-qt, scales[:, None, :, None].expand_as(qt), _tiles(x)), x.shape[2])


def _check_shapes(u: torch.Tensor, v: torch.Tensor, residual: torch.Tensor | None) -> None:
    if u.ndim != 3 or v.ndim != 3 or u.shape[:2] != v.shape[:2] or u.shape[1] != u.shape[2]:
        raise ValueError(f"need u (D, Ñ, Ñ) and v (D, Ñ, m); got {tuple(u.shape)}, {tuple(v.shape)}")
    want = (u.shape[0], u.shape[1], u.shape[1] + v.shape[2])
    if residual is not None and tuple(residual.shape) != want:
        raise ValueError(f"residual must be {want}; got {tuple(residual.shape)}")


def quantize_pack_plain(
    u: torch.Tensor, v: torch.Tensor, residual: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_shapes(u, v, residual)
    w = torch.cat([u.float(), v.float()], dim=2)
    x = w if residual is None else w + residual.float()
    codes, scales = quantize_tiles(x)
    return codes, scales, quantize_residual(x, codes, scales)


def quantize_pack(
    u: torch.Tensor, v: torch.Tensor, residual: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused publish step of a stacked fleet: u (D, Ñ, Ñ), v (D, Ñ, m),
    residual (D, Ñ, Ñ+m) or None → (codes int8 (D, Ñ, Ñ+m), scales f32
    (D, nt), residual' f32 (D, Ñ, Ñ+m)). The network ships codes and
    scales; ``dequantize_tiles`` recovers the payload."""
    _check_shapes(u, v, residual)
    if u.device.type == "cpu":
        return quantize_pack_plain(u, v, residual)
    inputs = {"u": u, "v": v} | ({} if residual is None else {"residual": residual})
    u, v, *rest = _lib.operands("quantize_pack", **inputs)
    residual = rest[0] if rest else None
    d, n, _ = u.shape
    m = v.shape[2]
    codes = torch.empty((d, n, n + m), dtype=torch.int8, device=u.device)
    scales = torch.empty((d, n_col_tiles(n + m)), dtype=torch.float32, device=u.device)
    resid = torch.empty((d, n, n + m), dtype=torch.float32, device=u.device)
    status = _lib.library().repro_quantize_pack(
        u.data_ptr(), v.data_ptr(), None if residual is None else residual.data_ptr(),
        codes.data_ptr(), scales.data_ptr(), resid.data_ptr(), d, n, m, _lib.stream(),
    )
    _lib.check(status, "quantize_pack")
    _lib.count_launch("quantize_pack")
    return codes, scales, resid
