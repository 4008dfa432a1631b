"""Recurrent sequence mixers on the chunked gated-linear-attention engine;
port of the Mamba parts of ``repro.models.ssm``.

    h_t = a_t · h_{t−1} + k_t v_tᵀ ,    y_t = h_tᵀ q_t

``chunked_linear_attention`` is the prefill's engine: it goes through
``repro_torch.kernels.gla_forward`` (the CUDA kernel on a card, its plain
version on the CPU), which returns the final state for the decode cache.
``linear_attention_decode_step`` is the O(1) recurrent step of decoding.
xLSTM's mLSTM and sLSTM are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.gla_scan import gla_forward

__all__ = ["chunked_linear_attention", "linear_attention_decode_step", "mamba_decode_step",
           "mamba_mix"]


def chunked_linear_attention(
    q: torch.Tensor,        # (B, S, H, dk)
    k: torch.Tensor,        # (B, S, H, dk)
    v: torch.Tensor,        # (B, S, H, dv)
    log_a: torch.Tensor,    # (B, S, H) per-token log decay (≤ 0)
) -> tuple[torch.Tensor, torch.Tensor]:
    """y_t = q_tᵀ h_t from a zero state; returns (y, h_S), h_S (B, H, dk, dv)
    in f32. Chunks are the kernel's (128 tokens)."""
    return gla_forward(q.contiguous(), k.contiguous(), v.contiguous(), log_a)


def linear_attention_decode_step(
    state: torch.Tensor,    # (B, H, dk, dv)
    q: torch.Tensor,        # (B, H, dk)
    k: torch.Tensor,
    v: torch.Tensor,        # (B, H, dv)
    log_a: torch.Tensor,    # (B, H)
) -> tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent decode: h ← a·h + k vᵀ; y = qᵀ h."""
    a = torch.exp(log_a)[..., None, None]
    state = state * a + k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", q.to(state.dtype), state)
    return state, y


def _mamba_inputs(p: dict, x: torch.Tensor, n_heads: int, ssm_state: int):
    """(xs, z, C, B, v, log a) of the selective SSM for x (..., D)."""
    xz = x @ p["in_proj"]
    xs, z = xz.chunk(2, dim=-1)
    di = xs.shape[-1]
    dh = di // n_heads
    dt = F.softplus((xs @ p["dt_proj"] + p["dt_bias"]).float()).to(xs.dtype)
    log_a = -dt * torch.exp(p["a_log"])
    lead = x.shape[:-1]
    bmat = (xs @ p["b_proj"]).reshape(*lead, n_heads, ssm_state)
    cmat = (xs @ p["c_proj"]).reshape(*lead, n_heads, ssm_state)
    vv = (xs * torch.repeat_interleave(dt, dh, dim=-1)).reshape(*lead, n_heads, dh)
    return xs, z, cmat, bmat, vv, log_a


def _mamba_out(p: dict, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Skip, gate and output projection. A decode step's y is f32 (the
    state is), and the projection then runs in f32, as jnp promotes it."""
    y = y + xs * p["d_skip"]
    y = y * F.silu(z.float()).to(y.dtype)
    return y @ p["out_proj"].to(y.dtype)


def mamba_mix(p: dict, x: torch.Tensor, *, n_heads: int, ssm_state: int):
    """Selective SSM with per-head scalar decay (Mamba-2 style heads) for x
    (B, S, D); returns (out (B, S, D), final state (B, H, n, dh)). The
    depthwise conv1d of the original Mamba is omitted, as in the reference."""
    b, s, _ = x.shape
    xs, z, cmat, bmat, vv, log_a = _mamba_inputs(p, x, n_heads, ssm_state)
    y, state = chunked_linear_attention(cmat, bmat, vv, log_a)
    return _mamba_out(p, y.reshape(b, s, -1), xs, z), state


def mamba_decode_step(p: dict, state: torch.Tensor, x: torch.Tensor, *, n_heads: int,
                      ssm_state: int):
    """x: (B, D) one token; state: (B, H, n, dh)."""
    b = x.shape[0]
    xs, z, cmat, bmat, vv, log_a = _mamba_inputs(p, x, n_heads, ssm_state)
    state, y = linear_attention_decode_step(state, cmat, bmat, vv, log_a)
    return state, _mamba_out(p, y.reshape(b, -1), xs, z)
