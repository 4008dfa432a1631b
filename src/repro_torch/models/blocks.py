"""Transformer blocks for every kind in ``ArchConfig.layer_pattern()``;
port of ``repro.models.blocks``.

Each kind defines, on ONE layer's parameters (the model keeps them
stacked per kind):

  init_block(generator, kind, cfg, dtype, device) -> params dict
  block_fwd(kind, p, x, ctx)                      -> (x, aux[3], cache | None)
  block_decode(kind, p, x_tok, cache, ctx)        -> (x_tok, cache)

aux is an f32[3] = (load balance, z-loss, dropped fraction) of the MoE
kinds, zeros for every other kind. With ``kv_cache_dtype =
"float8_e4m3fn"`` the attention caches are stored in float8 and upcast to
bf16 at the attention; the rounding into float8 is jnp's (``to_f8``), and
the cache's slots are written through its ``uint8`` view.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    apply_rope,
    blockwise_attention,
    cross_attention_blockwise,
    decode_attention,
    gelu_mlp,
    local_attention,
    rmsnorm,
    swiglu,
)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import (
    mamba_decode_step,
    mamba_mix,
    mlstm_decode_step,
    mlstm_mix,
    slstm_decode_step,
    slstm_mix,
)

F8 = torch.float8_e4m3fn
F8_LARGEST_ROUNDED = 464.0   # past it jnp's float8_e4m3fn rounds to NaN, torch's saturates


@dataclasses.dataclass(frozen=True)
class BlockCtx:
    """Loop-invariant context of the layer loop."""

    cfg: ArchConfig
    rope_cos: torch.Tensor | None = None    # (S, hd/2)
    rope_sin: torch.Tensor | None = None
    enc_out: torch.Tensor | None = None     # (B, T_enc, D) for the dec and xattn kinds
    causal: bool = True
    pos: int = 0                            # decode: current position
    collect_cache: bool = False             # prefill: emit decode caches
    cache_len: int = 0                      # prefill: decode-cache capacity (≥ S)


def _zero_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(3, dtype=torch.float32, device=x.device)


# ------------------------------------------------------------------ init


def _dense_init(gen: torch.Generator, shape, dtype, device, scale=None) -> torch.Tensor:
    """N(0, 1) · fan_in^−½, drawn in f32 on the generator's device, then cast
    and moved."""
    scale = scale if scale is not None else shape[0] ** -0.5
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * scale
    return x.to(device=device, dtype=dtype)


def _expert_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """``_dense_init`` of an (E, ·, ·) stack of experts (the reference's
    fan-in is E, its first axis), drawn an expert at a time: arctic's
    (128, 7168, 4864) leaf is 16.6 GiB in f32."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for e in range(shape[0]):
        out[e] = _dense_init(gen, shape[1:], dtype, device, scale=shape[0] ** -0.5)
    return out


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


def init_moe(gen, cfg: ArchConfig, dtype, device) -> dict:
    """The router in f32 (cast to x's type at use), the experts' SwiGLU
    weights stacked over E."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    return {
        "router": _dense_init(gen, (d, e), torch.float32, device),
        "w_gate": _expert_init(gen, (e, d, f), dtype, device),
        "w_up": _expert_init(gen, (e, d, f), dtype, device),
        "w_down": _expert_init(gen, (e, f, d), dtype, device),
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


def init_mlstm(gen, cfg: ArchConfig, dtype, device) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq": _dense_init(gen, (d, d), dtype, device),
        "wk": _dense_init(gen, (d, d), dtype, device),
        "wv": _dense_init(gen, (d, d), dtype, device),
        "wf": _dense_init(gen, (d, h), dtype, device),
        "bf": torch.full((h,), 3.0, dtype=dtype, device=device),   # open forget gates at init
        "wi": _dense_init(gen, (d, h), dtype, device),
        "bi": torch.zeros((h,), dtype=dtype, device=device),
        "wo_gate": _dense_init(gen, (d, h), dtype, device),
        "bo": torch.zeros((h,), dtype=dtype, device=device),
        "out_proj": _dense_init(gen, (d, d), dtype, device),
    }


def init_slstm(gen, cfg: ArchConfig, dtype, device) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    b_gates = torch.zeros((4 * d,), dtype=dtype, device=device)
    b_gates[d:2 * d] = 3.0                                             # the forget gates' block
    return {
        "w_gates": _dense_init(gen, (d, 4 * d), dtype, device),
        "b_gates": b_gates,
        "r_gates": _dense_init(gen, (h * dh, 4 * dh), dtype, device).reshape(h, dh, 4 * dh),
        "out_proj": _dense_init(gen, (d, d), dtype, device),
    }


def init_block(gen, kind: str, cfg: ArchConfig, dtype, device) -> dict:
    def ln():
        return torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)

    def attn():
        return init_attn(gen, cfg, dtype, device)

    def ffn():
        return init_ffn(gen, cfg, dtype, device)

    if kind in ("dense", "swa", "enc"):
        return {"ln1": ln(), "attn": attn(), "ln2": ln(), "ffn": ffn()}
    if kind == "moe":
        return {"ln1": ln(), "attn": attn(), "ln2": ln(), "moe": init_moe(gen, cfg, dtype, device)}
    if kind == "arctic":
        return {"ln1": ln(), "attn": attn(), "ln2": ln(), "ffn": ffn(),
                "moe": init_moe(gen, cfg, dtype, device)}
    if kind in ("hymba", "hymba_swa"):
        return {"ln1": ln(), "attn": attn(), "mamba": init_mamba(gen, cfg, dtype, device),
                "ln2": ln(), "ffn": ffn()}
    if kind == "mlstm":
        return {"ln1": ln(), "mlstm": init_mlstm(gen, cfg, dtype, device)}
    if kind == "slstm":
        return {"ln1": ln(), "slstm": init_slstm(gen, cfg, dtype, device)}
    if kind == "dec":
        return {"ln1": ln(), "attn": attn(), "ln_x": ln(), "xattn": attn(), "ln2": ln(),
                "ffn": ffn()}
    if kind == "xattn":
        return {"ln_x": ln(), "xattn": attn(),
                "gate": torch.zeros((), dtype=torch.float32, device=device), "ln2": ln(),
                "ffn": ffn()}
    raise ValueError(f"unknown block kind {kind!r}")


# --------------------------------------------------------------- forward


def to_f8(x: torch.Tensor) -> torch.Tensor:
    """x in float8_e4m3fn as jnp's ``astype`` rounds it: to the nearest,
    ties to even, and NaN with x's sign past ±464 (or for ±inf, NaN), where
    torch's conversion saturates at ±448."""
    bits = x.to(F8).view(torch.uint8)
    nan = (torch.signbit(x).to(torch.uint8) << 7) | 0x7F
    return torch.where((x.abs() > F8_LARGEST_ROUNDED) | torch.isnan(x), nan, bits).view(F8)


def _ffn_apply(cfg: ArchConfig, p_ffn: dict, h: torch.Tensor) -> torch.Tensor:
    if cfg.ffn_type == "gelu_mlp":
        return gelu_mlp(h, p_ffn["up"], p_ffn["down"])
    return swiglu(h, p_ffn["gate"], p_ffn["up"], p_ffn["down"])


def _moe_apply(cfg: ArchConfig, p_moe: dict, h: torch.Tensor, tokens_per_group: int):
    return moe_ffn(p_moe, h, n_experts=cfg.n_experts, top_k=cfg.experts_per_token,
                   tokens_per_group=tokens_per_group, capacity_factor=cfg.capacity_factor,
                   dispatch=cfg.moe_dispatch)


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
    ``cache_len`` may exceed S (pre-allocated decode capacity). A float8
    cache is placed by its bits."""
    if k_c.dtype == F8:
        return _rolled_cache(k_c.view(torch.uint8), cache_len).view(F8)
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
        if cfg.kv_cache_dtype == "float8_e4m3fn":
            k_c, v_c = to_f8(k_c), to_f8(v_c)
        cache = {"k": _rolled_cache(k_c, cl), "v": _rolled_cache(v_c, cl)}
    return o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"], cache


def _cross_attn(p, x, enc_out, cfg: ArchConfig):
    """Full attention from x (B, S, D) to the encoder's output (B, T, D):
    no rope, the kv heads repeated to H."""
    if enc_out is None:
        raise ValueError(f"{cfg.name}: cross attention needs the encoder's output; pass "
                         "frontend= to forward or prefill and enc_out= to decode_step")
    b, s, _ = x.shape
    t = enc_out.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (enc_out @ p["wk"]).reshape(b, t, kv, hd)
    v = (enc_out @ p["wv"]).reshape(b, t, kv, hd)
    if h != kv:
        k = torch.repeat_interleave(k, h // kv, dim=2)
        v = torch.repeat_interleave(v, h // kv, dim=2)
    o = cross_attention_blockwise(q, k, v)
    return o.reshape(b, s, h * hd) @ p["wo"]


def _gated(gate: torch.Tensor, o: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """tanh(gate) · o in f32 (jnp promotes the f32 gate's product), in
    ``like``'s type, so that the gate does not promote the carry."""
    return (torch.tanh(gate) * o.float()).to(like.dtype)


def block_fwd(kind: str, p: dict, x: torch.Tensor, ctx: BlockCtx):
    """Returns (x, aux[3], cache); cache is None unless
    ``ctx.collect_cache``."""
    cfg = ctx.cfg
    eps = cfg.norm_eps
    aux = _zero_aux(x)
    cache = None

    if kind in ("dense", "swa", "enc"):
        window = cfg.sliding_window if kind == "swa" else 0
        o, cache = _self_attn(p["attn"], rmsnorm(x, p["ln1"], eps), cfg, ctx, window=window,
                              causal=kind != "enc")
        x = x + o
        return x + _ffn_apply(cfg, p["ffn"], rmsnorm(x, p["ln2"], eps)), aux, cache

    if kind in ("moe", "arctic"):
        o, cache = _self_attn(p["attn"], rmsnorm(x, p["ln1"], eps), cfg, ctx)
        x = x + o
        h = rmsnorm(x, p["ln2"], eps)
        y, moe_aux = _moe_apply(cfg, p["moe"], h, cfg.tokens_per_group)
        if kind == "arctic":  # a dense FFN residual beside the MoE
            y = y + _ffn_apply(cfg, p["ffn"], h)
        aux = torch.stack([moe_aux["lb_loss"], moe_aux["z_loss"], moe_aux["dropped_frac"]])
        return x + y, aux, cache

    if kind in ("hymba", "hymba_swa"):
        h = rmsnorm(x, p["ln1"], eps)
        window = cfg.sliding_window if kind == "hymba_swa" else 0
        attn_out, attn_cache = _self_attn(p["attn"], h, cfg, ctx, window=window)
        mamba_out, ssm_state = mamba_mix(p["mamba"], h, n_heads=cfg.n_heads,
                                         ssm_state=cfg.ssm_state)
        x = x + 0.5 * (attn_out + mamba_out)     # parallel heads, fused mean
        x = x + _ffn_apply(cfg, p["ffn"], rmsnorm(x, p["ln2"], eps))
        if ctx.collect_cache:
            cache = {**attn_cache, "ssm": ssm_state}
        return x, aux, cache

    if kind == "mlstm":
        y, mem = mlstm_mix(p["mlstm"], rmsnorm(x, p["ln1"], eps), n_heads=cfg.n_heads)
        if ctx.collect_cache:
            cache = {"mem": mem}
        return x + y, aux, cache

    if kind == "slstm":
        y, st = slstm_mix(p["slstm"], rmsnorm(x, p["ln1"], eps), n_heads=cfg.n_heads)
        if ctx.collect_cache:
            cache = dict(zip("hcnm", st))
        return x + y, aux, cache

    if kind == "dec":
        o, cache = _self_attn(p["attn"], rmsnorm(x, p["ln1"], eps), cfg, ctx)
        x = x + o
        x = x + _cross_attn(p["xattn"], rmsnorm(x, p["ln_x"], eps), ctx.enc_out, cfg)
        return x + _ffn_apply(cfg, p["ffn"], rmsnorm(x, p["ln2"], eps)), aux, cache

    if kind == "xattn":
        o = _cross_attn(p["xattn"], rmsnorm(x, p["ln_x"], eps), ctx.enc_out, cfg)
        x = x + _gated(p["gate"], o, x)
        x = x + _ffn_apply(cfg, p["ffn"], rmsnorm(x, p["ln2"], eps))
        if ctx.collect_cache:
            cache = {}  # stateless in decode: k and v come from enc_out
        return x, aux, cache

    raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------- decode


def cache_spec(kind: str, cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """Shapes and types of one layer's decode cache."""
    kv, hd, h = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    d = cfg.d_model
    if cfg.kv_cache_dtype == "float8_e4m3fn":
        dt = F8
    else:
        dt = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
    if kind in ("dense", "moe", "arctic", "dec"):
        return {"k": ((batch, seq_len, kv, hd), dt), "v": ((batch, seq_len, kv, hd), dt)}
    if kind == "xattn":
        return {}
    if kind == "swa":
        w = min(cfg.sliding_window or seq_len, seq_len)
        return {"k": ((batch, w, kv, hd), dt), "v": ((batch, w, kv, hd), dt)}
    if kind in ("hymba", "hymba_swa"):
        w = seq_len if kind == "hymba" else min(cfg.sliding_window or seq_len, seq_len)
        di = cfg.mamba_expand * cfg.d_model
        return {
            "k": ((batch, w, kv, hd), dt), "v": ((batch, w, kv, hd), dt),
            "ssm": ((batch, h, cfg.ssm_state, di // h), torch.float32),
        }
    if kind == "mlstm":
        dh = d // h
        return {"mem": ((batch, h, dh, dh + 1), torch.float32)}
    if kind == "slstm":
        return {name: ((batch, d), torch.float32) for name in "hcnm"}
    raise ValueError(f"block kind {kind!r} has no decode cache")


def _write_slot(cache: torch.Tensor, slot: int, x1: torch.Tensor) -> None:
    """cache[:, slot] = x1 in the cache's type, in place (a float8 cache
    through its bits)."""
    if cache.dtype == F8:
        cache.view(torch.uint8)[:, slot] = to_f8(x1).view(torch.uint8)
    else:
        cache[:, slot] = x1.to(cache.dtype)


def _decode_self_attn(p, x_tok, cache_k, cache_v, cfg: ArchConfig, ctx: BlockCtx):
    """One-token attention against a (possibly rolling) cache: writes the
    token's k and v at slot pos % cache_len, in place, then attends over
    min(pos + 1, cache_len) valid slots (exact sliding-window semantics
    when cache_len is the window). A float8 cache is upcast to bf16 for
    the attention."""
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
    _write_slot(cache_k, slot, k1[:, 0])
    _write_slot(cache_v, slot, v1[:, 0])
    n_valid = min(pos + 1, cache_len)
    if cache_k.dtype == F8:
        o = decode_attention(q, cache_k.to(torch.bfloat16), cache_v.to(torch.bfloat16), n_valid)
    else:
        o = decode_attention(q, cache_k, cache_v, n_valid)
    return o.reshape(b, h * hd) @ p["wo"], cache_k, cache_v


def block_decode(kind: str, p: dict, x_tok: torch.Tensor, cache: dict, ctx: BlockCtx):
    """x_tok: (B, D) single-token hidden state. The k and v caches are
    written in place (and returned); the recurrent states are new tensors."""
    cfg = ctx.cfg
    eps = cfg.norm_eps

    if kind in ("dense", "swa", "moe", "arctic"):
        h = rmsnorm(x_tok, p["ln1"], eps)
        o, ck, cv = _decode_self_attn(p["attn"], h, cache["k"], cache["v"], cfg, ctx)
        x_tok = x_tok + o
        h2 = rmsnorm(x_tok, p["ln2"], eps)
        if kind in ("moe", "arctic"):
            y = _moe_apply(cfg, p["moe"], h2[:, None, :],
                           min(cfg.tokens_per_group, x_tok.shape[0]))[0][:, 0]
            if kind == "arctic":
                y = y + _ffn_apply(cfg, p["ffn"], h2)
        else:
            y = _ffn_apply(cfg, p["ffn"], h2)
        return x_tok + y, {**cache, "k": ck, "v": cv}

    if kind in ("hymba", "hymba_swa"):
        h = rmsnorm(x_tok, p["ln1"], eps)
        o, ck, cv = _decode_self_attn(p["attn"], h, cache["k"], cache["v"], cfg, ctx)
        ssm, ym = mamba_decode_step(
            p["mamba"], cache["ssm"], h, n_heads=cfg.n_heads, ssm_state=cfg.ssm_state
        )
        x_tok = x_tok + (0.5 * (o + ym)).to(x_tok.dtype)
        x_tok = x_tok + _ffn_apply(cfg, p["ffn"], rmsnorm(x_tok, p["ln2"], eps))
        return x_tok, {"k": ck, "v": cv, "ssm": ssm}

    if kind == "mlstm":
        h = rmsnorm(x_tok, p["ln1"], eps)
        mem, y = mlstm_decode_step(p["mlstm"], cache["mem"], h, n_heads=cfg.n_heads)
        return x_tok + y.to(x_tok.dtype), {"mem": mem.float()}

    if kind == "slstm":
        h = rmsnorm(x_tok, p["ln1"], eps)
        st = tuple(cache[name] for name in "hcnm")
        st, y = slstm_decode_step(p["slstm"], st, h, n_heads=cfg.n_heads)
        return x_tok + y, dict(zip("hcnm", st))

    if kind == "dec":
        h = rmsnorm(x_tok, p["ln1"], eps)
        o, ck, cv = _decode_self_attn(p["attn"], h, cache["k"], cache["v"], cfg, ctx)
        x_tok = x_tok + o
        hx = rmsnorm(x_tok, p["ln_x"], eps)
        x_tok = x_tok + _cross_attn(p["xattn"], hx[:, None, :], ctx.enc_out, cfg)[:, 0]
        x_tok = x_tok + _ffn_apply(cfg, p["ffn"], rmsnorm(x_tok, p["ln2"], eps))
        return x_tok, {**cache, "k": ck, "v": cv}

    if kind == "xattn":
        hx = rmsnorm(x_tok, p["ln_x"], eps)
        o = _cross_attn(p["xattn"], hx[:, None, :], ctx.enc_out, cfg)[:, 0]
        x_tok = x_tok + _gated(p["gate"], o, x_tok)
        x_tok = x_tok + _ffn_apply(cfg, p["ffn"], rmsnorm(x_tok, p["ln2"], eps))
        return x_tok, cache

    raise ValueError(f"unknown block kind {kind!r}")
