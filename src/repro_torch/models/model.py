"""Model assembly: embedding → the layers in pattern order → logits or
the loss; port of ``repro.models.model``.

Parameters are a nested dict of tensors with the reference's layout:
``{"embed", "final_norm", "layers": {kind: {...}}}``, plus ``enc_layers``
and ``enc_norm`` for an encoder-decoder and ``frontend_proj`` for a
config with a frontend; each leaf of ``layers[kind]`` is stacked over
that kind's layers in pattern order, so that
``repro_torch.convert.model_params_from_numpy`` carries the reference's
pytree over as it is. The layers run as a plain Python loop (the port
runs eagerly; nothing is traced). Where a gradient is taken, each layer
runs under a non-reentrant ``torch.utils.checkpoint``, as the reference
wraps each scanned block in ``jax.checkpoint`` (its ``remat``): the
backward recomputes one layer's activations at a time, so training holds
the layers' inputs and one layer's working set.
The frontends are stubs, as in the reference: precomputed embeddings (B,
T, d_frontend) stand in for the speech encoder's frames and the ViT's
patches. ``lm_loss`` computes the cross-entropy in chunks of
``loss_chunk`` tokens, each chunk's logits recomputed in the backward, so
that (B, S, V) logits never exist at once. ``input_specs`` and
``cache_shape_structs`` give the model's inputs and decode caches as
tensors on the ``meta`` device, shapes and types that allocate nothing (the
reference's ``ShapeDtypeStruct`` trees, leaf by leaf), for the dry run.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.models.blocks import BlockCtx, block_decode, block_fwd, cache_spec, init_block
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.layers import rmsnorm, rope_tables

PyTree = Any

__all__ = ["LB_WEIGHT", "Z_WEIGHT", "active_param_count", "cache_shape_structs", "decode_step",
           "encoder_forward", "forward", "group_runs", "init_params", "input_specs", "lm_loss",
           "param_count", "param_dtype", "prefill"]


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


def _stack_layers(gen, kinds: tuple[str, ...], cfg: ArchConfig, dtype, device) -> dict:
    """Draw each layer in pattern order into its kind's stack. A kind of one
    layer keeps its leaves (a view with the stacked axis); a kind of more
    is copied into its stack a layer at a time, so that drawing holds the
    stack and one layer, never every layer twice."""
    n = {kind: kinds.count(kind) for kind in kinds}
    stacks: dict[str, dict] = {}
    filled: dict[str, int] = {}
    for kind in kinds:
        layer = init_block(gen, kind, cfg, dtype, device)
        if kind not in stacks:
            stacks[kind] = _map(lambda t, m=n[kind]: t.unsqueeze(0) if m == 1
                                else t.new_empty((m, *t.shape)), layer)
            filled[kind] = 0
        if n[kind] > 1:
            _put(stacks[kind], layer, filled[kind])
        filled[kind] += 1
    return stacks


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _put(stack, layer, i: int) -> None:
    """stack[i] = layer, leaf by leaf."""
    for k, v in layer.items():
        if isinstance(v, dict):
            _put(stack[k], v, i)
        else:
            stack[k][i] = v


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def init_params(generator: torch.Generator, cfg: ArchConfig, *,
                device: str | torch.device | None = None) -> dict:
    """Random weights from ``generator`` (drawn on the generator's device, so
    a CUDA generator draws a full-width model on the card) on ``device``
    (the card unless ``device="cpu"``), in the reference's order: the
    embedding, the layers, the encoder's layers, the frontend's
    projection. The reference draws with ``jax.random``, whose streams
    torch cannot reproduce: to run both packages on one set of weights,
    convert the reference's (``repro_torch.convert.model_params_from_numpy``)."""
    device = resolve_device(device)
    dtype = param_dtype(cfg)
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=generator, device=generator.device)
    params = {
        "embed": (embed * 0.02).to(device=device, dtype=dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
    }
    del embed
    params["layers"] = _stack_layers(generator, cfg.layer_pattern(), cfg, dtype, device)
    if cfg.is_encdec:
        params["enc_layers"] = _stack_layers(generator, cfg.encoder_pattern(), cfg, dtype, device)
        params["enc_norm"] = torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)
    if cfg.frontend is not None:
        proj = torch.randn((cfg.d_frontend, cfg.d_model), generator=generator,
                           device=generator.device)
        params["frontend_proj"] = (proj * cfg.d_frontend ** -0.5).to(device=device, dtype=dtype)
    return params


def param_count(params: PyTree) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def active_param_count(params: dict, cfg: ArchConfig) -> int:
    """MoE-aware: the parameters a token runs through (top-k of E
    experts)."""
    total = param_count(params)
    if not cfg.n_experts:
        return total
    expert_leaves = 0
    for kind in ("moe", "arctic"):
        stack = params["layers"].get(kind)
        if stack is not None and "moe" in stack:
            expert_leaves += sum(stack["moe"][w].numel() for w in ("w_gate", "w_up", "w_down"))
    active_frac = cfg.experts_per_token / cfg.n_experts
    return int(total - expert_leaves * (1.0 - active_frac))


def _needs_grad(x: torch.Tensor, tree) -> bool:
    """Whether autograd records this layer: grad mode on, and x or a weight
    requires a gradient."""
    if not torch.is_grad_enabled():
        return False
    if isinstance(tree, dict):
        return x.requires_grad or any(_needs_grad(x, t) for t in tree.values())
    return tree.requires_grad


def _run_layers(layers: dict, pattern: tuple[str, ...], x: torch.Tensor, ctx: BlockCtx):
    """Every layer in pattern order; returns (x, the aux vectors summed, the
    caches stacked per kind or None). A layer that autograd records (and
    that collects no cache) runs under a non-reentrant checkpoint: its
    activations are recomputed in the backward."""
    aux_total = torch.zeros(3, dtype=torch.float32, device=x.device)
    caches: dict[str, list] = {}
    for kind, i in _layer_slots(pattern):
        p = _index(layers[kind], i)
        if not ctx.collect_cache and _needs_grad(x, p):
            x, aux, cache = checkpoint(block_fwd, kind, p, x, ctx, use_reentrant=False)
        else:
            x, aux, cache = block_fwd(kind, p, x, ctx)
        aux_total = aux_total + aux
        if ctx.collect_cache:
            caches.setdefault(kind, []).append(cache)
    if not ctx.collect_cache:
        return x, aux_total, None
    return x, aux_total, {kind: _stack(parts) for kind, parts in caches.items()}


def encoder_forward(params: dict, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """The frontend stub's embeddings (B, T, d_frontend) → the projection →
    the bidirectional encoder and its norm (an encoder-decoder), or the
    projection alone (a VLM): (B, T, D) in the parameters' type."""
    x = frames.to(param_dtype(cfg)) @ params["frontend_proj"]
    if cfg.is_encdec:
        cos, sin = rope_tables(x.shape[1], cfg.head_dim, cfg.rope_theta, device=x.device)
        ctx = BlockCtx(cfg=cfg, rope_cos=cos, rope_sin=sin, causal=False)
        x, _, _ = _run_layers(params["enc_layers"], cfg.encoder_pattern(), x, ctx)
        x = rmsnorm(x, params["enc_norm"], cfg.norm_eps)
    return x


def forward(
    params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
    frontend: torch.Tensor | None = None, collect_cache: bool = False, cache_len: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, PyTree]:
    """tokens (B, S) → (hidden (B, S, D), aux[3] f32, caches or None).
    ``frontend``: the stub embeddings (B, T, d_frontend), run through
    ``encoder_forward`` for the cross-attention layers."""
    s = tokens.shape[1]
    x = params["embed"][tokens]
    enc_out = None if frontend is None else encoder_forward(params, cfg, frontend)
    cos, sin = rope_tables(s, cfg.head_dim, cfg.rope_theta, device=x.device)
    ctx = BlockCtx(cfg=cfg, rope_cos=cos, rope_sin=sin, enc_out=enc_out,
                   collect_cache=collect_cache, cache_len=max(cache_len, s))
    x, aux, caches = _run_layers(params["layers"], cfg.layer_pattern(), x, ctx)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux, caches


# ------------------------------------------------------------------ loss

LB_WEIGHT = 0.01
Z_WEIGHT = 1e-3


def _chunk_ce(h_c: torch.Tensor, l_c: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Σ (logsumexp − the label's logit) over a chunk (B, c, D) of hidden
    states, the logits in f32 from the product in the parameters' type."""
    logits = (h_c @ embed.T).float()                                  # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, l_c[..., None].long())[..., 0]
    return (lse - ll).sum()


def lm_loss(
    params: dict, cfg: ArchConfig, tokens: torch.Tensor, labels: torch.Tensor, *,
    frontend: torch.Tensor | None = None, loss_chunk: int = 512,
) -> tuple[torch.Tensor, dict]:
    """The next-token cross-entropy over tokens (B, S) and labels (B, S),
    plus ``LB_WEIGHT``·load balance and ``Z_WEIGHT``·z-loss of the MoE
    kinds; returns (loss, metrics): ``ce``, ``lb_loss``, ``z_loss``,
    ``dropped_frac`` and ``features``, the pooled final hidden state (B, D)
    in f32, detached (the paper's feature tap). The cross-entropy runs over
    chunks of ``loss_chunk`` tokens and, as the reference's, over the first
    ⌊S / c⌋·c tokens; where a gradient is taken each chunk is checkpointed."""
    hidden, aux, _ = forward(params, cfg, tokens, frontend=frontend)
    b, s, _ = hidden.shape
    embed = params["embed"]
    c = min(loss_chunk, s)
    n = s // c
    grad = torch.is_grad_enabled() and (hidden.requires_grad or embed.requires_grad)
    total = None
    for i in range(n):
        h_c, l_c = hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        part = (checkpoint(_chunk_ce, h_c, l_c, embed, use_reentrant=False) if grad
                else _chunk_ce(h_c, l_c, embed))
        total = part if total is None else total + part
    ce = total / (b * n * c)
    loss = ce + LB_WEIGHT * aux[0] + Z_WEIGHT * aux[1]
    metrics = {"ce": ce, "lb_loss": aux[0], "z_loss": aux[1], "dropped_frac": aux[2],
               "features": hidden.detach().mean(dim=1).float()}
    return loss, metrics


def prefill(
    params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
    frontend: torch.Tensor | None = None, cache_len: int = 0,
) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """→ (last-token logits (B, V) f32, caches, features (B, D) f32)."""
    hidden, _, caches = forward(params, cfg, tokens, frontend=frontend, collect_cache=True,
                                cache_len=cache_len)
    logits = (hidden[:, -1] @ params["embed"].T).float()
    features = hidden.mean(dim=1).float()
    return logits, caches, features


def decode_step(
    params: dict, cfg: ArchConfig, token: torch.Tensor, caches: dict, pos: int, *,
    enc_out: torch.Tensor | None = None, max_seq: int = 0,
) -> tuple[torch.Tensor, dict]:
    """One serve step: logits (B, V) f32 for the token after ``token`` (B,)
    at position ``pos``; ``enc_out`` is ``encoder_forward``'s output for
    the cross-attention layers. The caches are updated in place and
    returned: the reference returns new arrays, which here would copy
    every layer's cache for every token."""
    if max_seq <= 0:
        raise ValueError("decode_step needs max_seq for the RoPE table")
    x = params["embed"][token]
    cos, sin = rope_tables(max_seq + 1, cfg.head_dim, cfg.rope_theta, device=x.device)
    ctx = BlockCtx(cfg=cfg, rope_cos=cos, rope_sin=sin, enc_out=enc_out, pos=int(pos))
    for kind, i in _layer_slots(cfg.layer_pattern()):
        cache = _index(caches[kind], i)
        x, new = block_decode(kind, _index(params["layers"][kind], i), x, cache, ctx)
        for name, t in new.items():
            if t is not cache[name]:
                cache[name].copy_(t)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["embed"].T).float(), caches


# ------------------------------------------------------------ input specs


def _spec(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    """A shape-and-type stand-in: a tensor on the ``meta`` device."""
    return torch.empty(shape, dtype=dtype, device="meta")


def cache_shape_structs(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """{kind: {name: stand-in}} matching ``decode_step``'s caches, each leaf
    stacked over that kind's layers."""
    counts: dict[str, int] = {}
    for kind in cfg.layer_pattern():
        counts[kind] = counts.get(kind, 0) + 1
    return {kind: {name: _spec((n, *shape), dtype)
                   for name, (shape, dtype) in cache_spec(kind, cfg, batch, seq_len).items()}
            for kind, n in counts.items()}


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Stand-ins for every model input of ``shape`` (no allocation): tokens
    and labels (train), tokens (prefill), or one token, the caches of a
    ``seq_len`` context and the position (decode); the frontend's
    embeddings, or for decode the encoder's output, where ``cfg`` has a
    frontend."""
    b, s = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    specs: dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = _spec((b, s), i32)
        if shape.kind == "train":
            specs["labels"] = _spec((b, s), i32)
        if cfg.frontend is not None:
            specs["frontend"] = _spec((b, cfg.n_frontend_tokens, cfg.d_frontend), f32)
    else:  # decode: one token against a seq_len cache
        specs["token"] = _spec((b,), i32)
        specs["caches"] = cache_shape_structs(cfg, b, s)
        specs["pos"] = _spec((), i32)
        if cfg.frontend is not None:
            specs["enc_out"] = _spec((b, cfg.n_frontend_tokens, cfg.d_model), f32)
    return specs
