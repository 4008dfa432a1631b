"""Fused attention forward with an online softmax; port of
``repro.kernels.flash_attn``.

``flash_attention`` takes ``flash_attention_plain`` for CPU tensors and
launches a kernel of ``csrc/flash_attn.cu`` for CUDA tensors, or raises:
bf16 on the tensor cores, f32 on the CUDA cores. q, k and v are (B, S, H,
hd) with the kv heads already repeated to H, f32 or bf16 on the card (a
mix, or another floating type, computes in f32: ``_lib.operands``, with p
still rounded to v's type before p·v); the result has q's shape and type.
Any head width and any view go: a width under 256 runs the next larger of
the kernel's instances (64, 128, 256) masked at hd, bf16 on the CUDA cores
where its 16-byte copies cannot go (hd not a multiple of 8, or a view off
a 16-byte boundary), and a width past 256 a kernel that streams q·kᵀ over
hd in slices. The plain version walks the KV axis in the kernel's tiles of
64 keys with the kernel's arithmetic (scale after the dot product, −1e30
for masked scores, p rounded to v's type before p·v, out = acc / max(l,
1e-30)); its dot products are PyTorch's, so the two agree to f32 rounding,
not bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

__all__ = ["flash_attention", "flash_attention_plain"]

NEG_INF = -1e30
KV_TILE = 64               # keys per tile, the kernel's kBK
# the C entry's p_round: where v came as bf16 or f16 and the kernel runs in
# f32 (a mix of types, or f16), p is rounded to v's type before p·v
P_ROUND = {torch.bfloat16: 1, torch.float16: 2}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, S, H, hd) with k and v alike")
    if (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, heads or head width")


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    _check(q, k, v)
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = hd ** -0.5
    qf = q.transpose(1, 2).float()                      # (B, H, Sq, hd)
    kf = k.transpose(1, 2).float()
    vt = v.transpose(1, 2)
    qpos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, KV_TILE):
        k1 = min(k0 + KV_TILE, sk)
        s = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        if causal:
            s = torch.where(kpos <= qpos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(v.dtype).float() @ vt[:, :, k0:k1].float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """softmax(q·kᵀ·hd^−½ + mask)·v for q (B, Sq, H, hd), k, v (B, Sk, H,
    hd); ``causal`` masks the keys after the query's row."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    _check(q, k, v)
    dtype, p_round = q.dtype, P_ROUND.get(v.dtype, 0)
    q, k, v = _lib.operands("flash_attention", _lib.F32_BF16, q=q, k=k, v=v)
    b, sq, h, hd = q.shape
    out = torch.empty_like(q)
    status = _lib.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, sq, k.shape[1], hd,
        int(causal), hd ** -0.5, int(q.dtype == torch.bfloat16), p_round, _lib.stream(),
    )
    _lib.check(status, "flash_attention")
    _lib.count_launch("flash_attention")
    return out.to(dtype)
