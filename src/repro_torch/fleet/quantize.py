"""Block-quantized (U, V) merge payloads with error feedback; port of
``repro.fleet.quantize``.

- **Per-tile int8** — the stacked payload w = [U | V] is cut into
  ``TILE_COLS``-wide column tiles; each (device, tile) is quantized
  symmetrically against its own absolute maximum and ships as int8 codes
  plus one f32 scale (``quantize_tiles`` / ``dequantize_tiles``).
- **f16** — a plain half-precision round trip, no scales.
- **Error feedback** — each device keeps the residual
  r ← (w + r) − dq(q(w + r)) and adds it back before its next publish, so
  repeated lossy merges stay unbiased.
- **Mixed-precision rounds** — ``apply_codec``'s ``fp_mask`` devices
  (quarantine risk) publish exact f32 and clear their residual;
  ``participate``-masked devices publish nothing and keep their residual.

The arithmetic is the reference's to the bit: IEEE divisions for the
scale and the codes, round half to even, and the residual x − q·scale
rounded once (XLA contracts it into a fused multiply-add), while the
published payload q·scale is a plain product. The tile codec itself
(``quantize_tiles``, ``dequantize_tiles``) lives beside its fused kernel
in ``repro_torch.kernels.quantize_pack``.
"""
from __future__ import annotations

import torch

from repro_torch.core import OSELMState
from repro_torch.kernels.quantize_pack import (
    TILE_COLS,
    dequantize_tiles,
    n_col_tiles,
    quantize_residual,
    quantize_tiles,
)

__all__ = [
    "PRECISIONS",
    "ITEMSIZE",
    "TILE_COLS",
    "apply_codec",
    "dequantize_tiles",
    "init_residual",
    "n_col_tiles",
    "payload_precision_nbytes",
    "quantize_roundtrip",
    "quantize_tiles",
    "validate_precision",
]

PRECISIONS = ("f32", "f16", "int8")
ITEMSIZE = {"f32": 4, "f16": 2, "int8": 1}
SCALE_ITEMSIZE = 4       # per-tile scales ship as f32


def validate_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown payload precision {precision!r}; have {PRECISIONS}")


def payload_precision_nbytes(n_hidden: int, n_out: int, precision: str) -> int:
    """Bytes one (U, V) payload ships at ``precision``: Ñ(Ñ+m) values at
    the precision's item size, plus one f32 scale per column tile for
    int8."""
    validate_precision(precision)
    numel = n_hidden * (n_hidden + n_out)
    if precision == "int8":
        return numel + n_col_tiles(n_hidden + n_out) * SCALE_ITEMSIZE
    return numel * ITEMSIZE[precision]


def quantize_roundtrip(x: torch.Tensor, precision: str) -> torch.Tensor:
    """What the network delivers: the payload after one quantize →
    dequantize trip at ``precision`` (identity for f32)."""
    validate_precision(precision)
    if precision == "f32":
        return x
    if precision == "f16":
        return x.half().float()
    return dequantize_tiles(*quantize_tiles(x))


# ---------------------------------------------------- error-feedback codec


def apply_codec(
    w: torch.Tensor,
    precision: str,
    *,
    residual: torch.Tensor | None = None,
    fp_mask: torch.Tensor | None = None,
    participate: torch.Tensor | None = None,
    roundtrip: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One publish step of the lossy payload exchange over the stacked
    (D, R, C) payload ``w``. Returns ``(published, residual')``:

    - quantized devices publish dq(q(w + residual)) and carry the error
      (w + residual) − published forward;
    - ``fp_mask`` devices publish exact ``w`` and their residual resets
      to 0;
    - devices that ``participate`` leaves out publish their exact ``w``
      (the merge mask zeroes it) and keep their residual.

    ``roundtrip`` optionally injects the (published, residual') pair of
    x = w + residual that the ``quantize_pack`` kernel computed, so the
    kernel path shares this blending. With ``residual=None`` the backlog
    is zero and residual' is still returned."""
    validate_precision(precision)
    if precision == "f32":
        return w, residual
    r0 = torch.zeros_like(w) if residual is None else residual
    if roundtrip is not None:
        published, new_r = roundtrip
    elif precision == "f16":
        x = w + r0
        published = x.half().float()
        new_r = x - published
    else:
        x = w + r0
        codes, scales = quantize_tiles(x)
        published = dequantize_tiles(codes, scales)
        new_r = quantize_residual(x, codes, scales)
    if fp_mask is not None:
        fp = fp_mask.to(device=w.device, dtype=torch.bool)[:, None, None]
        published = torch.where(fp, w, published)
        new_r = torch.where(fp, torch.zeros_like(new_r), new_r)
    if participate is not None:
        live = participate.to(device=w.device, dtype=torch.bool)[:, None, None]
        published = torch.where(live, published, w)
        new_r = torch.where(live, new_r, r0)
    return published, new_r


def init_residual(states: OSELMState) -> torch.Tensor:
    """A zeroed error-feedback accumulator for a stacked fleet: one
    (Ñ, Ñ+m) payload residual per device."""
    d, n, m = states.beta.shape
    return torch.zeros((d, n, n + m), dtype=torch.float32, device=states.device)
