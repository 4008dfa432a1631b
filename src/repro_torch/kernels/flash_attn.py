"""Fused attention with an online softmax, forward and backward; port of
``repro.kernels.flash_attn`` and of the custom VJP around the reference's
``models/layers.py::blockwise_attention`` (``_fa_backward_impl``).

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

Where grad mode is on and q, k or v requires a gradient, ``flash_attention``
is a ``torch.autograd.Function`` (``FlashAttention``): its forward also
writes each query row's running max m and sum l (B, H, Sq) in f32, and its
backward is ``flash_attention_bwd``, the kernels of
``csrc/flash_attn_bwd.cu`` on the card (``flash_attention_bwd_plain`` on
the CPU). The backward follows ``_fa_backward_inner``: δ = rowsum(dout ∘
out), p = exp(s − m) / max(l, 1e-30) with s masked to −1e30, dv = pᵀ·dout,
dp = dout·vᵀ, ds = p ∘ (dp − δ)·hd^−½, dq = ds·k, dk = dsᵀ·q, with f32
sums, the results in q's, k's and v's types. It takes every head width
the forward takes. Up to 256, bf16 runs on the tensor cores where the
forward's does (hd a multiple of 8, every tensor on a 16-byte boundary),
else (hd not a multiple of 8, a view off 16 bytes) on the CUDA cores; past
256 both types run the wide pair on the CUDA cores, which streams q·kᵀ
and dout·vᵀ over hd in slices of 64, as the wide forward does. On every
route p is rounded to bf16 before pᵀ·dout and ds before ds·k and dsᵀ·q, as
FlashAttention-2 and cuDNN round them, and the plain version takes these
two roundings, and no other, when q, k, v, out and dout are all bf16.
That is where the port's bf16 backward departs from the reference's,
which keeps p and ds in f32 and rounds s to bf16 instead
(``models/layers.py:220``, ``:227-230``): the two differ by about one
bf16 rounding of the terms.
Without a gradient to take, the forward runs as before, with no statistics.
The plain versions compute in f64 where every operand is f64 (so that
``torch.autograd.gradcheck`` can hold the Function), else in f32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

__all__ = ["FlashAttention", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_fwd", "flash_attention_plain"]

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


def _compute_type(*tensors: torch.Tensor) -> torch.dtype:
    """The plain versions' type: f64 where every operand is f64, else f32."""
    return torch.float64 if all(t.dtype == torch.float64 for t in tensors) else torch.float32


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    stats: bool = False,
):
    """The output, or with ``stats`` (output, m, l), m and l (B, H, Sq)."""
    _check(q, k, v)
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = hd ** -0.5
    ct = _compute_type(q, k, v)
    qf = q.transpose(1, 2).to(ct)                        # (B, H, Sq, hd)
    kf = k.transpose(1, 2).to(ct)
    vt = v.transpose(1, 2)
    qpos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, h, sq), NEG_INF, dtype=ct, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, sq, hd), dtype=ct, device=q.device)
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
        acc = acc * alpha[..., None] + p.to(v.dtype).to(ct) @ vt[:, :, k0:k1].to(ct)
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2).to(q.dtype)
    return (out, m, l) if stats else out


def _forward(q, k, v, causal: bool, stats: bool):
    """The forward on q's device: (out, m, l) with ``stats``, else out."""
    if _lib.on_cpu(q):
        return _lib.plain("flash_attention", flash_attention_plain, q, k, v, causal=causal,
                          stats=stats)
    _check(q, k, v)
    dtype, p_round = q.dtype, P_ROUND.get(v.dtype, 0)
    q, k, v = _lib.operands("flash_attention", _lib.F32_BF16, q=q, k=k, v=v)
    b, sq, h, hd = q.shape
    out = torch.empty_like(q)
    m = l = None
    if stats:
        m, l = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device) for _ in range(2))
    status = _lib.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _lib.ptr(m), _lib.ptr(l),
        b, h, sq, k.shape[1], hd, int(causal), hd ** -0.5, int(q.dtype == torch.bfloat16),
        p_round, _lib.stream(),
    )
    _lib.check(status, "flash_attention")
    _lib.count_launch("flash_attention")
    return (out.to(dtype), m, l) if stats else out.to(dtype)


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward with its row statistics: (output, m, l), m and l (B, H,
    Sq), what ``flash_attention_bwd`` takes."""
    return _forward(q, k, v, causal, stats=True)


def _bwd_plain(q, k, v, out, dout, m, l, causal: bool):
    """(dq, dk, dv) (B, S, H, hd) in the compute type, before the rounding
    to the operands' types: ``flash_attention_bwd_plain``'s arithmetic."""
    _check(q, k, v)
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = hd ** -0.5
    ct = _compute_type(q, k, v, out, dout)
    rounded = all(t.dtype == torch.bfloat16 for t in (q, k, v, out, dout))
    qf, kf, vf, of, dof = (x.transpose(1, 2).to(ct) for x in (q, k, v, out, dout))
    delta = (dof * of).sum(-1)                           # (B, H, Sq)
    m, l = m.to(ct), torch.clamp(l.to(ct), min=1e-30)
    qpos = torch.arange(sq, device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for k0 in range(0, sk, KV_TILE):
        k1 = min(k0 + KV_TILE, sk)
        kt, vt = kf[:, :, k0:k1], vf[:, :, k0:k1]
        s = (qf @ kt.transpose(-1, -2)) * scale
        if causal:
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            s = torch.where(kpos <= qpos, s, NEG_INF)
        p = torch.exp(s - m[..., None]) / l[..., None]
        ds = p * (dof @ vt.transpose(-1, -2) - delta[..., None]) * scale
        if rounded:  # the bf16 kernels' operands: p and ds in bf16
            p, ds = (x.to(torch.bfloat16).to(ct) for x in (p, ds))
        dvs.append(p.transpose(-1, -2) @ dof)
        dq = dq + ds @ kt
        dks.append(ds.transpose(-1, -2) @ qf)
    dk = torch.cat(dks, 2) if dks else torch.zeros_like(kf)
    dv = torch.cat(dvs, 2) if dvs else torch.zeros_like(vf)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
    m: torch.Tensor, l: torch.Tensor, *, causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's, k's and v's types, over the key tiles of 64 in
    order (each tile's dk and dv whole, dq summed tile after tile); with
    q, k, v, out and dout all bf16, p and ds rounded to bf16 before the
    products they enter."""
    grads = _bwd_plain(q, k, v, out, dout, m, l, causal)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
    m: torch.Tensor, l: torch.Tensor, *, causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention``'s output ``out``
    against ``dout``, from its forward's row statistics m and l (B, H, Sq)
    f32. On the card two launches (one count): the dq kernel, which also
    writes δ, then the dk/dv kernel, on the tensor cores for bf16 where
    their 16-byte copies go, else on the CUDA cores, and past hd 256 the
    wide pair; each gradient element is written by one block, in a fixed
    order."""
    if _lib.on_cpu(q):
        return _lib.plain("flash_attention_bwd", flash_attention_bwd_plain, q, k, v, out, dout,
                          m, l, causal=causal)
    _check(q, k, v)
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    dtypes = q.dtype, k.dtype, v.dtype
    q, k, v, out, dout = _lib.operands("flash_attention_bwd", _lib.F32_BF16, q=q, k=k, v=v,
                                       out=out, dout=dout)
    m, l = (t.float().contiguous() for t in (m, l))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    status = _lib.library().repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        m.data_ptr(), l.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        delta.data_ptr(), b, h, sq, sk, hd, int(causal), hd ** -0.5,
        int(q.dtype == torch.bfloat16), _lib.stream(),
    )
    _lib.check(status, "flash_attention_bwd")
    _lib.count_launch("flash_attention_bwd")
    return dq.to(dtypes[0]), dk.to(dtypes[1]), dv.to(dtypes[2])


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward: the forward saves q, k, v, the
    output and the row statistics, the backward recomputes the scores from
    them (``flash_attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, m, l = _forward(q, k, v, causal, stats=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, m, l)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, dout, m, l, causal=ctx.causal), None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """softmax(q·kᵀ·hd^−½ + mask)·v for q (B, Sq, H, hd), k, v (B, Sk, H,
    hd); ``causal`` masks the keys after the query's row. Differentiable
    (``FlashAttention``) where a gradient is to be taken."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, stats=False)
