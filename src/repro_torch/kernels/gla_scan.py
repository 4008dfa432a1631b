"""Chunked gated-linear-attention forward; port of ``repro.kernels.gla_scan``.

``gla_forward`` takes ``gla_forward_plain`` for CPU tensors and launches
the kernels of ``csrc/gla_scan.cu`` for CUDA tensors, or raises. q and k
are (B, S, H, dk), v (B, S, H, dv), all of one type (f32 or bf16), and
log a (B, S, H) the per-token log decay; it returns y (B, S, H, dv) in
q's type and the final state (B, H, dk, dv) in f32, which the reference's
kernel drops. Chunks are min(128, S) tokens. On the card one call runs
the chunks in parallel: each chunk's state increment, the carry of the
state through the chunks in order, then each chunk's output (three
launches, one count); where dk × dv needs more shared memory than a block
has (``wide_path``: from 128 × 64 or 96 × 96 on), the same three passes run
over 64 × 64 tiles of the state and 64-column tiles of y, streaming q, k and
the state through shared memory. The plain version repeats the kernels' arithmetic
chunk by chunk: f32 inside, the cumsum of log a sequential in token
order, the gate by select, the carry S·e^{tot} + ΔS, padding with
log a = 0 and zeroed q, k, v; its products are PyTorch's, so the two
agree to f32 rounding, not bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

__all__ = ["CHUNK", "gla_forward", "gla_forward_plain", "wide_path"]

CHUNK = 128  # tokens per chunk at most, the kernel's kMaxChunk


def wide_path(dk: int, dv: int) -> bool:
    """Whether the card runs dk × dv on the tiled wide path (the chunk
    kernels' shared memory past a block's)."""
    return _lib.library().repro_gla_smem(dk, dv) > _lib.MAX_SMEM


def _check(q, k, v, log_a) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.ndim != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"gla_forward: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, S, H, dk), (B, S, H, dk), (B, S, H, dv)")
    if log_a.shape != q.shape[:3]:
        raise ValueError(f"gla_forward: log_a must be {tuple(q.shape[:3])}, got {tuple(log_a.shape)}")


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 cumsum over the last axis, one token after the other as
    the kernels' scanning thread adds them (``torch.cumsum`` on the CPU sums
    in f64, on the card in a parallel scan)."""
    out = x.clone()
    for t in range(1, x.shape[-1]):
        out[..., t] = out[..., t - 1] + x[..., t]
    return out


def gla_forward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_a: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    _check(q, k, v, log_a)
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = min(CHUNK, s)
    state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    if s == 0:
        return torch.empty_like(v, dtype=q.dtype), state
    n = -(-s // c)
    pad = n * c - s

    def chunks(x):  # (B, S, H, ...) → (B, H, n, c, ...) f32, zero-padded
        x = x.float().transpose(1, 2)
        x = torch.nn.functional.pad(x, (0, 0) * (x.ndim - 3) + (0, pad))
        return x.reshape(b, h, n, c, *x.shape[3:])

    qc, kc, vc, lac = chunks(q), chunks(k), chunks(v), chunks(log_a)
    cum = _sequential_cumsum(lac)                        # (B, H, n, c)
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    ys = []
    for i in range(n):
        qi, ki, vi, cu = qc[:, :, i], kc[:, :, i], vc[:, :, i], cum[:, :, i]
        tot = cu[..., -1]
        y = (qi * torch.exp(cu)[..., None]) @ state
        gate = torch.where(tri, torch.exp(cu[..., :, None] - cu[..., None, :]), 0.0)
        y = y + ((qi @ ki.transpose(-1, -2)) * gate) @ vi
        ys.append(y)
        w = torch.exp(tot[..., None] - cu)[..., None]
        state = state * torch.exp(tot)[..., None, None] + (ki * w).transpose(-1, -2) @ vi
    y = torch.stack(ys, 2).reshape(b, h, n * c, dv)[:, :, :s].transpose(1, 2)
    return y.to(q.dtype), state


def gla_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_a: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, final state) of h_t = a_t·h_{t−1} + k_t v_tᵀ, y_t = q_tᵀ h_t."""
    if q.device.type == "cpu":
        return gla_forward_plain(q, k, v, log_a)
    _check(q, k, v, log_a)
    bf16 = _lib.require_cuda_f32_or_bf16("gla_forward", q=q, k=k, v=v)
    la = log_a.float().contiguous()
    _lib.require_cuda_f32("gla_forward", log_a=la)
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    y = torch.empty_like(v, dtype=q.dtype)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=q.device)
    if s == 0:
        return y, state.zero_()
    c = min(CHUNK, s)
    n = -(-s // c)
    lib = _lib.library()
    # the kernels' scratch: each chunk's state increment, then the state
    # entering it, and each chunk's decay e^{tot}; (B, H, n, dk, dv) f32 is
    # 268 MB at B = 4, S = 2048, H = 4 and xLSTM's dk × dv = 512 × 513
    dstate = torch.empty((b, h, n, dk, dv), dtype=torch.float32, device=q.device)
    decay = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    status = lib.repro_gla_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), la.data_ptr(), y.data_ptr(), state.data_ptr(),
        dstate.data_ptr(), decay.data_ptr(), b, s, h, dk, dv, c, bf16, _lib.stream(),
    )
    _lib.check(status, "gla_forward")
    _lib.count_launch("gla_forward")
    return y, state
