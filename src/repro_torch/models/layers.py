"""Shared transformer layers: RMSNorm, RoPE, attention, FFNs; port of
``repro.models.layers`` (forward only).

``blockwise_attention`` is the fused attention of the prefill: it goes
through ``repro_torch.kernels.flash_attention`` (the CUDA kernel on a
card, its plain version on the CPU). ``blockwise_attention_fwd_only`` is
the reference's chunked online-softmax oracle in plain PyTorch, for
tests. ``local_attention`` (exact sliding window, O(S·2w)) and
``decode_attention`` (one token against a cache) are plain PyTorch here,
as they are plain jnp in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attn import NEG_INF, flash_attention

__all__ = [
    "apply_rope", "blockwise_attention", "blockwise_attention_fwd_only", "decode_attention",
    "gelu_mlp", "local_attention", "rmsnorm", "rope_tables", "swiglu",
]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rope_tables(seq_len: int, head_dim: int, theta: float, *, device=None,
                dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    ang = pos[:, None] * freqs[None, :]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (S, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """GQA: repeat kv heads to match query heads. (B,S,KV,hd)->(B,S,H,hd)."""
    return k if groups == 1 else torch.repeat_interleave(k, groups, dim=2)


def blockwise_attention_fwd_only(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, chunk: int = 512,
) -> torch.Tensor:
    """The reference's flash-style forward: query chunks of ``chunk`` rows,
    each scanning the KV chunks with an online softmax. Plain PyTorch."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = hd ** -0.5
    cq, ck = min(chunk, sq), min(chunk, sk)
    nq, nk = -(-sq // cq), -(-sk // ck)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * cq - sq)).reshape(b, nq, cq, h, hd).permute(1, 0, 3, 2, 4)
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * ck - sk)).reshape(b, nk, ck, h, hd).permute(1, 0, 3, 2, 4)
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * ck - sk)).reshape(b, nk, ck, h, hd).permute(1, 0, 3, 2, 4)
    q_pos = torch.arange(nq * cq, device=q.device).reshape(nq, cq)
    k_pos = torch.arange(nk * ck, device=q.device).reshape(nk, ck)
    outs = []
    for qi in range(nq):
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, cq, hd), dtype=torch.float32, device=q.device)
        for kj in range(nk):
            s = (qp[qi] @ kp[kj].transpose(-1, -2)).float() * scale
            mask = (k_pos[kj] < sk)[None, :]
            if causal:
                mask = mask & (k_pos[kj][None, :] <= q_pos[qi][:, None])
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + (p.to(vp.dtype) @ vp[kj]).float()
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, nq * cq, h, hd)[:, :sq]
    return out.to(q.dtype)


def blockwise_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Fused attention forward for q (B, Sq, H, hd) and k, v (B, Sk, H, hd)
    with the kv heads repeated: ``flash_attention``, whose kernel picks its
    own tiles (the reference's ``chunk`` has no counterpart, nor its
    ``q_offset``, which no caller passes)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int) -> torch.Tensor:
    """Exact causal sliding-window attention, O(S · 2w): queries chunked at
    the window size, each chunk attending its own and the previous chunk
    with the in-window causal mask."""
    b, s, h, hd = q.shape
    w = window
    scale = hd ** -0.5
    n = -(-s // w)
    pad = n * w - s
    qp = F.pad(q, (0, 0, 0, 0, 0, pad)).reshape(b, n, w, h, hd)
    kp = F.pad(k, (0, 0, 0, 0, 0, pad)).reshape(b, n, w, h, hd)
    vp = F.pad(v, (0, 0, 0, 0, 0, pad)).reshape(b, n, w, h, hd)
    k_prev = torch.cat([torch.zeros_like(kp[:, :1]), kp[:, :-1]], dim=1)
    v_prev = torch.cat([torch.zeros_like(vp[:, :1]), vp[:, :-1]], dim=1)
    kk = torch.cat([k_prev, kp], dim=2)  # (B,n,2w,H,hd)
    vv = torch.cat([v_prev, vp], dim=2)

    dev = q.device
    srel_q = torch.arange(w, device=dev)
    srel_k = torch.arange(2 * w, device=dev) - w
    mask_rel = (srel_k[None, :] <= srel_q[:, None]) & (srel_q[:, None] - srel_k[None, :] < w)
    k_abs = torch.arange(n, device=dev)[:, None] * w + srel_k[None, :]
    valid_abs = (k_abs >= 0) & (k_abs < s)

    scores = torch.einsum("bnqhd,bnkhd->bnhqk", qp, kk).float() * scale
    m = mask_rel[None, None, None, :, :] & valid_abs[None, :, None, None, :]
    scores = torch.where(m, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(vv.dtype)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", p, vv)
    return out.reshape(b, n * w, h, hd)[:, :s].to(q.dtype)


def decode_attention(
    q1: torch.Tensor,        # (B, 1, H, hd) — the new token's query
    cache_k: torch.Tensor,   # (B, S, KV, hd)
    cache_v: torch.Tensor,
    pos: int,                # number of valid cache entries
    *,
    window: int = 0,
) -> torch.Tensor:
    """Single-token decode attention over a (possibly windowed) KV cache."""
    b, s, kv, hd = cache_k.shape
    groups = q1.shape[2] // kv
    k = _expand_kv(cache_k, groups)
    v = _expand_kv(cache_v, groups)
    scale = hd ** -0.5
    s_pos = torch.arange(s, device=q1.device)
    valid = s_pos < pos
    if window:
        valid = valid & (s_pos >= pos - window)
    scores = torch.einsum("bqhd,bshd->bhqs", q1, k).float() * scale
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p, v).to(q1.dtype)


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    g = x @ gate
    u = x @ up
    return (F.silu(g.float()).to(u.dtype) * u) @ down


def gelu_mlp(x: torch.Tensor, up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """GPT-BigCode-style MLP (granite code models): up → GELU → down."""
    u = x @ up
    return F.gelu(u.float(), approximate="tanh").to(u.dtype) @ down
