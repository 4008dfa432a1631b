"""Transformer blocks; port of ``repro.models.blocks`` for the kinds
``dense``, ``swa``, ``hymba`` and ``hymba_swa``.

Each kind defines, on ONE layer's parameters (the model keeps them
stacked per kind):

  init_block(generator, kind, cfg, dtype, device) -> params dict
  block_fwd(kind, p, x, ctx)                      -> (x, cache | None)
  block_decode(kind, p, x_tok, cache, ctx)        -> (x_tok, cache)

The reference's blocks also return an aux vector of MoE losses; none of
the ported kinds has one, so it is left out until MoE is ported. Every
other kind raises ``NotImplementedError`` (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    apply_rope,
    blockwise_attention,
    decode_attention,
    gelu_mlp,
    local_attention,
    rmsnorm,
    swiglu,
)
from repro_torch.models.ssm import mamba_decode_step, mamba_mix

PORTED_KINDS = ("dense", "swa", "hymba", "hymba_swa")


def require_ported(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP queue 1, item 10: the model "
            f"zoo); the port runs {PORTED_KINDS}"
        )


@dataclasses.dataclass(frozen=True)
class BlockCtx:
    """Loop-invariant context of the layer loop."""

    cfg: ArchConfig
    rope_cos: torch.Tensor | None = None    # (S, hd/2)
    rope_sin: torch.Tensor | None = None
    pos: int = 0                            # decode: current position
    collect_cache: bool = False             # prefill: emit decode caches
    cache_len: int = 0                      # prefill: decode-cache capacity (≥ S)


# ------------------------------------------------------------------ init


def _dense_init(gen: torch.Generator, shape, dtype, device, scale=None) -> torch.Tensor:
    """N(0, 1) · fan_in^−½, drawn in f32 on the generator's device, then cast
    and moved."""
    scale = scale if scale is not None else shape[0] ** -0.5
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * scale
    return x.to(device=device, dtype=dtype)


def init_attn(gen, cfg: ArchConfig, dtype, device) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": _dense_init(gen, (d, h * hd), dtype, device),
        "wk": _dense_init(gen, (d, kv * hd), dtype, device),
        "wv": _dense_init(gen, (d, kv * hd), dtype, device),
        "wo": _dense_init(gen, (h * hd, d), dtype, device),
    }


def init_ffn(gen, cfg: ArchConfig, dtype, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.ffn_type == "gelu_mlp":  # GPT-BigCode style: up/gelu/down
        return {"up": _dense_init(gen, (d, f), dtype, device),
                "down": _dense_init(gen, (f, d), dtype, device)}
    return {
        "gate": _dense_init(gen, (d, f), dtype, device),
        "up": _dense_init(gen, (d, f), dtype, device),
        "down": _dense_init(gen, (f, d), dtype, device),
    }


def init_mamba(gen, cfg: ArchConfig, dtype, device) -> dict:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    h, n = cfg.n_heads, cfg.ssm_state
    return {
        "in_proj": _dense_init(gen, (d, 2 * di), dtype, device),
        "dt_proj": _dense_init(gen, (di, h), dtype, device),
        "dt_bias": torch.zeros((h,), dtype=dtype, device=device),
        "b_proj": _dense_init(gen, (di, h * n), dtype, device),
        "c_proj": _dense_init(gen, (di, h * n), dtype, device),
        "a_log": torch.zeros((h,), dtype=torch.float32, device=device),
        "d_skip": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": _dense_init(gen, (di, d), dtype, device),
    }


def init_block(gen, kind: str, cfg: ArchConfig, dtype, device) -> dict:
    require_ported(kind)

    def ln():
        return torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)

    if kind in ("dense", "swa"):
        return {"ln1": ln(), "attn": init_attn(gen, cfg, dtype, device), "ln2": ln(),
                "ffn": init_ffn(gen, cfg, dtype, device)}
    return {"ln1": ln(), "attn": init_attn(gen, cfg, dtype, device),
            "mamba": init_mamba(gen, cfg, dtype, device), "ln2": ln(),
            "ffn": init_ffn(gen, cfg, dtype, device)}


# --------------------------------------------------------------- forward


def _ffn_apply(cfg: ArchConfig, p_ffn: dict, h: torch.Tensor) -> torch.Tensor:
    if cfg.ffn_type == "gelu_mlp":
        return gelu_mlp(h, p_ffn["up"], p_ffn["down"])
    return swiglu(h, p_ffn["gate"], p_ffn["up"], p_ffn["down"])


def _qkv(p, x, cfg: ArchConfig, ctx: BlockCtx, *, rope: bool = True):
    """(q, k, v) with the kv heads repeated to H, plus the unrepeated
    (k, v) for the decode cache."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kv, hd)
    v = (x @ p["wv"]).reshape(b, s, kv, hd)
    if rope and ctx.rope_cos is not None:
        q = apply_rope(q, ctx.rope_cos[:s], ctx.rope_sin[:s])
        k = apply_rope(k, ctx.rope_cos[:s], ctx.rope_sin[:s])
    k_c, v_c = k, v
    if h != kv:
        k = torch.repeat_interleave(k, h // kv, dim=2)
        v = torch.repeat_interleave(v, h // kv, dim=2)
    return q, k, v, k_c, v_c


def _rolled_cache(k_c: torch.Tensor, cache_len: int) -> torch.Tensor:
    """The last ``min(cache_len, S)`` entries at their rolling slots
    (slot = abs_pos % cache_len), so that decode continues seamlessly;
    ``cache_len`` may exceed S (pre-allocated decode capacity)."""
    b, s, kv, hd = k_c.shape
    n_keep = min(cache_len, s)
    slots = torch.arange(s - n_keep, s, device=k_c.device) % cache_len
    out = torch.zeros((b, cache_len, kv, hd), dtype=k_c.dtype, device=k_c.device)
    out[:, slots] = k_c[:, s - n_keep:]
    return out


def _self_attn(p, x, cfg: ArchConfig, ctx: BlockCtx, *, window: int = 0, causal: bool = True):
    b, s, _ = x.shape
    q, k, v, k_c, v_c = _qkv(p, x, cfg, ctx)
    if window and s > window:
        o = local_attention(q, k, v, window=window)
    else:
        o = blockwise_attention(q, k, v, causal=causal)
    cache = None
    if ctx.collect_cache:
        cap = max(ctx.cache_len, s)
        cl = min(window, cap) if window else cap
        cache = {"k": _rolled_cache(k_c, cl), "v": _rolled_cache(v_c, cl)}
    return o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"], cache


def block_fwd(kind: str, p: dict, x: torch.Tensor, ctx: BlockCtx):
    """Returns (x, cache); cache is None unless ``ctx.collect_cache``."""
    require_ported(kind)
    cfg = ctx.cfg
    eps = cfg.norm_eps
    if kind in ("dense", "swa"):
        window = cfg.sliding_window if kind == "swa" else 0
        o, cache = _self_attn(p["attn"], rmsnorm(x, p["ln1"], eps), cfg, ctx, window=window)
        x = x + o
        return x + _ffn_apply(cfg, p["ffn"], rmsnorm(x, p["ln2"], eps)), cache

    h = rmsnorm(x, p["ln1"], eps)
    window = cfg.sliding_window if kind == "hymba_swa" else 0
    attn_out, attn_cache = _self_attn(p["attn"], h, cfg, ctx, window=window)
    mamba_out, ssm_state = mamba_mix(p["mamba"], h, n_heads=cfg.n_heads, ssm_state=cfg.ssm_state)
    x = x + 0.5 * (attn_out + mamba_out)     # parallel heads, fused mean
    x = x + _ffn_apply(cfg, p["ffn"], rmsnorm(x, p["ln2"], eps))
    cache = {**attn_cache, "ssm": ssm_state} if ctx.collect_cache else None
    return x, cache


# ---------------------------------------------------------------- decode


def cache_spec(kind: str, cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """Shapes and types of one layer's decode cache."""
    require_ported(kind)
    kv, hd, h = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    dt = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
    if kind == "dense":
        return {"k": ((batch, seq_len, kv, hd), dt), "v": ((batch, seq_len, kv, hd), dt)}
    if kind == "swa":
        w = min(cfg.sliding_window or seq_len, seq_len)
        return {"k": ((batch, w, kv, hd), dt), "v": ((batch, w, kv, hd), dt)}
    w = seq_len if kind == "hymba" else min(cfg.sliding_window or seq_len, seq_len)
    di = cfg.mamba_expand * cfg.d_model
    return {
        "k": ((batch, w, kv, hd), dt), "v": ((batch, w, kv, hd), dt),
        "ssm": ((batch, h, cfg.ssm_state, di // h), torch.float32),
    }


def _decode_self_attn(p, x_tok, cache_k, cache_v, cfg: ArchConfig, ctx: BlockCtx):
    """One-token attention against a (possibly rolling) cache: writes the
    token's k and v at slot pos % cache_len, in place, then attends over
    min(pos + 1, cache_len) valid slots (exact sliding-window semantics
    when cache_len is the window)."""
    b = x_tok.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = ctx.pos
    cache_len = cache_k.shape[1]
    q = (x_tok @ p["wq"]).reshape(b, 1, h, hd)
    k1 = (x_tok @ p["wk"]).reshape(b, 1, kv, hd)
    v1 = (x_tok @ p["wv"]).reshape(b, 1, kv, hd)
    if ctx.rope_cos is not None:
        cos, sin = ctx.rope_cos[pos:pos + 1], ctx.rope_sin[pos:pos + 1]
        q = apply_rope(q, cos, sin)
        k1 = apply_rope(k1, cos, sin)
    slot = pos % cache_len
    cache_k[:, slot] = k1[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v1[:, 0].to(cache_v.dtype)
    o = decode_attention(q, cache_k, cache_v, min(pos + 1, cache_len))
    return o.reshape(b, h * hd) @ p["wo"], cache_k, cache_v


def block_decode(kind: str, p: dict, x_tok: torch.Tensor, cache: dict, ctx: BlockCtx):
    """x_tok: (B, D) single-token hidden state. The k and v caches are
    written in place (and returned); the ssm state is a new tensor."""
    require_ported(kind)
    cfg = ctx.cfg
    eps = cfg.norm_eps
    h = rmsnorm(x_tok, p["ln1"], eps)
    o, ck, cv = _decode_self_attn(p["attn"], h, cache["k"], cache["v"], cfg, ctx)
    if kind in ("dense", "swa"):
        x_tok = x_tok + o
        x_tok = x_tok + _ffn_apply(cfg, p["ffn"], rmsnorm(x_tok, p["ln2"], eps))
        return x_tok, {**cache, "k": ck, "v": cv}
    ssm, ym = mamba_decode_step(
        p["mamba"], cache["ssm"], h, n_heads=cfg.n_heads, ssm_state=cfg.ssm_state
    )
    x_tok = x_tok + (0.5 * (o + ym)).to(x_tok.dtype)
    x_tok = x_tok + _ffn_apply(cfg, p["ffn"], rmsnorm(x_tok, p["ln2"], eps))
    return x_tok, {"k": ck, "v": cv, "ssm": ssm}
