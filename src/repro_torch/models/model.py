"""Model assembly: embedding → the layers in pattern order → logits;
port of the serving half of ``repro.models.model``.

Parameters are a nested dict of tensors with the reference's layout:
``{"embed", "final_norm", "layers": {kind: {...}}}``, each leaf of
``layers[kind]`` stacked over that kind's layers in pattern order, so
that ``repro_torch.convert.model_params_from_numpy`` carries the
reference's pytree over as it is. The layers run as a plain Python loop
(the port runs eagerly; nothing is traced or rematerialised).
``lm_loss``, ``encoder_forward``, ``input_specs`` and
``cache_shape_structs`` are not ported yet (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch._device import resolve_device
from repro_torch.models.blocks import (
    BlockCtx,
    block_decode,
    block_fwd,
    init_block,
    require_ported,
)
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import rmsnorm, rope_tables

PyTree = Any

__all__ = ["decode_step", "forward", "group_runs", "init_params", "param_count", "param_dtype",
           "prefill"]


def group_runs(pattern: tuple[str, ...]) -> list[tuple[str, int]]:
    """Consecutive same-kind runs: ('a','a','b','a') → [(a,2),(b,1),(a,1)]."""
    runs: list[tuple[str, int]] = []
    for k in pattern:
        if runs and runs[-1][0] == k:
            runs[-1] = (k, runs[-1][1] + 1)
        else:
            runs.append((k, 1))
    return runs


def _layer_slots(pattern: tuple[str, ...]):
    """(kind, index within the kind's stack) of every layer, in order."""
    seen: dict[str, int] = {}
    for kind, count in group_runs(pattern):
        off = seen.get(kind, 0)
        seen[kind] = off + count
        for i in range(off, off + count):
            yield kind, i


def _index(tree, i: int):
    """One layer's view of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _stack_layers(gen, kinds: tuple[str, ...], cfg: ArchConfig, dtype, device) -> dict:
    """Draw each layer in pattern order, then stack per kind."""
    per_kind: dict[str, list] = {}
    for kind in kinds:
        per_kind.setdefault(kind, []).append(init_block(gen, kind, cfg, dtype, device))
    return {kind: _stack(layers) for kind, layers in per_kind.items()}


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def init_params(generator: torch.Generator, cfg: ArchConfig, *,
                device: str | torch.device | None = None) -> dict:
    """Random weights from ``generator`` (drawn on the generator's device, so
    a CUDA generator draws a full-width model on the card) on ``device``
    (the card unless ``device="cpu"``). The reference draws with
    ``jax.random``, whose streams torch cannot reproduce: to run both
    packages on one set of weights, convert the reference's
    (``repro_torch.convert.model_params_from_numpy``)."""
    device = resolve_device(device)
    pattern = cfg.layer_pattern()
    for kind in dict.fromkeys(pattern):
        require_ported(kind)
    if cfg.is_encdec or cfg.frontend is not None or cfg.kv_cache_dtype != "param":
        raise NotImplementedError(
            f"{cfg.name}: encoders, frontends and float8 caches are not ported yet "
            "(ROADMAP queue 1, item 10: the model zoo)")
    dtype = param_dtype(cfg)
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=generator, device=generator.device)
    return {
        "embed": (embed * 0.02).to(device=device, dtype=dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
        "layers": _stack_layers(generator, pattern, cfg, dtype, device),
    }


def param_count(params: PyTree) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def _run_layers(layers: dict, pattern: tuple[str, ...], x: torch.Tensor, ctx: BlockCtx):
    """Every layer in pattern order; returns (x, caches stacked per kind, or
    None)."""
    caches: dict[str, list] = {}
    for kind, i in _layer_slots(pattern):
        x, cache = block_fwd(kind, _index(layers[kind], i), x, ctx)
        if ctx.collect_cache:
            caches.setdefault(kind, []).append(cache)
    if not ctx.collect_cache:
        return x, None
    return x, {kind: _stack(parts) for kind, parts in caches.items()}


def forward(
    params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
    collect_cache: bool = False, cache_len: int = 0,
) -> tuple[torch.Tensor, PyTree]:
    """tokens (B, S) → (hidden (B, S, D), caches or None)."""
    s = tokens.shape[1]
    x = params["embed"][tokens]
    cos, sin = rope_tables(s, cfg.head_dim, cfg.rope_theta, device=x.device)
    ctx = BlockCtx(cfg=cfg, rope_cos=cos, rope_sin=sin, collect_cache=collect_cache,
                   cache_len=max(cache_len, s))
    x, caches = _run_layers(params["layers"], cfg.layer_pattern(), x, ctx)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), caches


def prefill(
    params: dict, cfg: ArchConfig, tokens: torch.Tensor, *, cache_len: int = 0,
) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """→ (last-token logits (B, V) f32, caches, features (B, D) f32)."""
    hidden, caches = forward(params, cfg, tokens, collect_cache=True, cache_len=cache_len)
    logits = (hidden[:, -1] @ params["embed"].T).float()
    features = hidden.mean(dim=1).float()
    return logits, caches, features


def decode_step(
    params: dict, cfg: ArchConfig, token: torch.Tensor, caches: dict, pos: int, *,
    max_seq: int = 0,
) -> tuple[torch.Tensor, dict]:
    """One serve step: logits (B, V) f32 for the token after ``token`` (B,)
    at position ``pos``. The caches are updated in place and returned:
    the reference returns new arrays, which here would copy every layer's
    cache for every token."""
    if max_seq <= 0:
        raise ValueError("decode_step needs max_seq for the RoPE table")
    x = params["embed"][token]
    cos, sin = rope_tables(max_seq + 1, cfg.head_dim, cfg.rope_theta, device=x.device)
    ctx = BlockCtx(cfg=cfg, rope_cos=cos, rope_sin=sin, pos=int(pos))
    for kind, i in _layer_slots(cfg.layer_pattern()):
        cache = _index(caches[kind], i)
        x, new = block_decode(kind, _index(params["layers"][kind], i), x, cache, ctx)
        for name, t in new.items():
            if t is not cache[name]:
                cache[name].copy_(t)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["embed"].T).float(), caches
