"""Recurrent sequence mixers: the selective SSM (Mamba-style) and xLSTM's
mLSTM and sLSTM; port of ``repro.models.ssm``.

    h_t = a_t · h_{t−1} + k_t v_tᵀ ,    y_t = h_tᵀ q_t

``chunked_linear_attention`` is the engine of Mamba and the mLSTM, in the
prefill and in training: it goes through ``repro_torch.kernels.gla_forward``
(the CUDA kernels on a card, their plain version on the CPU; where a
gradient is taken, ``GLAForward``, whose backward is a kernel family too),
which returns the final state for the decode cache.
``linear_attention_decode_step`` is the O(1) recurrent step of decoding. The sLSTM's recurrence is nonlinear (h feeds
the gates), so it runs token by token in plain PyTorch, in f32, as the
reference's ``lax.scan`` does.

Types follow jnp's promotion where torch's differs: a product of an f32
tensor and bf16 weights (a decode step's state, the sLSTM's carry) runs
in f32, and an f32 0-d array times a bf16 tensor is f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.gla_scan import gla_forward

__all__ = ["chunked_linear_attention", "linear_attention_decode_step", "mamba_decode_step",
           "mamba_mix", "mlstm_decode_step", "mlstm_mix", "slstm_decode_step", "slstm_mix"]


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


# ---------------------------------------------------------------- mLSTM


def _mlstm_inputs(p: dict, x: torch.Tensor, n_heads: int):
    """(q, k·i, v with a ones column, log f, o) of the mLSTM for x (..., D),
    each (..., H, ·) or (..., H)."""
    lead, d = x.shape[:-1], x.shape[-1]
    dh = d // n_heads
    q = (x @ p["wq"]).reshape(*lead, n_heads, dh)
    k = (x @ p["wk"]).reshape(*lead, n_heads, dh)
    # jnp.sqrt(dh) is a weakly typed f32 scalar: it takes k's type before
    # the division, as here
    k = k / float(torch.tensor(float(dh)).sqrt().to(k.dtype))
    v = (x @ p["wv"]).reshape(*lead, n_heads, dh)
    log_f = F.logsigmoid(x @ p["wf"] + p["bf"])                 # (..., H) ≤ 0
    log_i = x @ p["wi"] + p["bi"]
    i_gate = torch.exp(torch.clamp(log_i, max=0.0))            # stabilized input gate
    o_gate = torch.sigmoid(x @ p["wo_gate"] + p["bo"])
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    return q, k * i_gate[..., None], v_aug, log_f, o_gate


def _mlstm_out(p: dict, y_aug: torch.Tensor, o_gate: torch.Tensor) -> torch.Tensor:
    """Numerator over max(|normalizer|, 1), the output gate, the projection
    (in f32 when y is, as jnp promotes a decode step's f32 y)."""
    y = y_aug[..., :-1] / torch.clamp(y_aug[..., -1:].abs(), min=1.0)
    y = y * o_gate[..., None]
    return y.flatten(-2) @ p["out_proj"].to(y.dtype)


def mlstm_mix(p: dict, x: torch.Tensor, *, n_heads: int):
    """xLSTM matrix-memory mixer for x (B, S, D):

    C_t = f_t C_{t−1} + i_t v_t k_tᵀ;  n_t = f_t n_{t−1} + i_t k_t;
    y_t = (C_t q_t) / max(|n_t·q_t|, 1),

    on the chunked engine with v augmented by a ones column, so that the
    numerator and the normalizer come out of one pass (dk = dh, dv =
    dh + 1). Returns (out (B, S, D), final state (B, H, dh, dh + 1) f32).
    The engine sums the log decays in f32 whatever their type; the
    reference's scan sums them in log f's type (bf16 at full width).
    """
    q, k, v_aug, log_f, o_gate = _mlstm_inputs(p, x, n_heads)
    y_aug, state = chunked_linear_attention(q, k, v_aug, log_f)
    return _mlstm_out(p, y_aug, o_gate), state


def mlstm_decode_step(p: dict, state: torch.Tensor, x: torch.Tensor, *, n_heads: int):
    """x: (B, D) one token; state: (B, H, dh, dh + 1), the matrix memory with
    its normalizer column. Returns (state, out (B, D)), out in f32 as jnp
    promotes the f32 state's product."""
    q, k, v_aug, log_f, o_gate = _mlstm_inputs(p, x, n_heads)
    state, y_aug = linear_attention_decode_step(state, q, k, v_aug, log_f)
    return state, _mlstm_out(p, y_aug, o_gate)


# ---------------------------------------------------------------- sLSTM


def _slstm_cell(r_gates: torch.Tensor, gx: torch.Tensor, h, c, n, m, n_heads: int):
    """One step of the exponentially gated scalar memory with the m
    stabilizer, in f32. The recurrent term is per head, (B, H, 4·dh),
    reshaped to (B, 4·D) and split into four chunks of D: heads and gates
    interleave, as the reference's layout does."""
    b, d = h.shape
    rec = torch.einsum("bhd,hde->bhe", h.reshape(b, n_heads, d // n_heads), r_gates)
    gi, gf, gz, go = (gx + rec.reshape(b, 4 * d)).chunk(4, dim=-1)
    log_f = F.logsigmoid(gf)
    m_new = torch.maximum(log_f + m, gi)
    i_s = torch.exp(gi - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(gz)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1.0)
    return h_new, c_new, n_new, m_new


def slstm_mix(p: dict, x: torch.Tensor, *, n_heads: int):
    """xLSTM scalar-memory mixer for x (B, S, D): the nonlinear recurrence
    token by token from h = c = n = 0 and m = −1e30, in f32. Returns (out
    (B, S, D), (h, c, n, m) each (B, D) f32)."""
    b, s, d = x.shape
    gates_x = (x @ p["w_gates"] + p["b_gates"]).float()        # (B, S, 4D)
    r_gates = p["r_gates"].float()
    z = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    st = (z, z, z, torch.full((b, d), -1e30, dtype=torch.float32, device=x.device))
    hs = []
    for t in range(s):
        st = _slstm_cell(r_gates, gates_x[:, t], *st, n_heads)
        hs.append(st[0])
    y = torch.stack(hs, dim=1).to(x.dtype)
    return y @ p["out_proj"], st


def slstm_decode_step(p: dict, state, x: torch.Tensor, *, n_heads: int):
    """state: (h, c, n, m) each (B, D) f32; x: (B, D) one token. Returns
    (state, out (B, D) in x's type)."""
    gx = (x @ p["w_gates"] + p["b_gates"]).float()
    st = _slstm_cell(p["r_gates"].float(), gx, *state, n_heads)
    return st, st[0].to(x.dtype) @ p["out_proj"]
