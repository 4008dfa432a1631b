"""Train, serve and detector step factories; port of ``repro.launch.steps``.

``make_train_step``: the gradient of ``lm_loss`` by autograd (the
attention's backward a kernel on the card, ``kernels.flash_attention``),
accumulated in f32 over ``cfg.num_microbatches`` micro-batches, clipped to a
global norm of 1, then the optimizer's update. It returns the detector's
feature tap beside the metrics, so that the paper's OS-ELM monitor can take
it. The step runs eagerly: the reference's ``jax.jit`` has no counterpart
here. Given a ``Mesh``, the gradients and the loss are averaged over its
data axes before the clip (data parallelism: each rank holds its block of
the batch, every rank the same parameters).

``make_detector_step``: the paper's technique as a mesh program. Each rank
steps its OS-ELM autoencoder on its block of the features (Eq. 12, batch
k); with ``merge``, the one-shot cooperative update (Eq. 8) runs as one
all-reduce of (U, V) and ``from_uv``, as
``federated.mesh_federation._merge`` does.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any

import torch

from repro_torch.core import UV, OSELMState, from_uv, oselm_step, to_uv
from repro_torch.models import decode_step, lm_loss, prefill
from repro_torch.models.config import ArchConfig
from repro_torch.optim import Optimizer, adam, clip_by_global_norm, global_norm, tree_leaves

__all__ = ["loss_and_grads", "make_decode_step", "make_detector_step", "make_optimizer",
           "make_prefill_step", "make_train_step"]

PyTree = Any

STACKED = ("layers", "enc_layers")   # the parameters stacked over each kind's layers


def make_optimizer(cfg: ArchConfig, lr: float = 3e-4) -> Optimizer:
    """Adam, with bf16 moments where ``cfg.moment_dtype`` says so (else the
    moments take the parameters' type, as the reference's do)."""
    moment_dtype = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else None
    return adam(lr, moment_dtype=moment_dtype)


def _live(tree: PyTree, stacked: bool = False) -> PyTree:
    """The parameters as leaves that take a gradient, views of the same
    memory. A leaf stacked over layers becomes a list of one leaf a layer
    (the model indexes either alike), so that each layer's gradient is a
    tensor of its own: autograd through one slice of a stacked leaf writes
    a zero-filled gradient of the whole stack and adds it, for every layer."""
    if isinstance(tree, dict):
        return {k: _live(v, stacked or k in STACKED) for k, v in tree.items()}
    if stacked:
        return [t.detach().requires_grad_(True) for t in tree.detach().unbind(0)]
    return tree.detach().requires_grad_(True)


def _rebuild(tree: PyTree, leaves, stacked: bool = False) -> PyTree:
    """``leaves`` (in ``tree_leaves`` order, a stacked leaf's layers one by
    one where ``stacked``) in ``tree``'s structure."""
    it = iter(leaves)

    def build(t, st):
        if isinstance(t, dict):
            done = {k: build(t[k], st or (stacked and k in STACKED)) for k in sorted(t)}
            return {k: done[k] for k in t}
        return torch.stack([next(it) for _ in range(t.shape[0])]) if st else next(it)

    return build(tree, False)


def loss_and_grads(cfg: ArchConfig, params: PyTree, tokens, labels, frontend=None):
    """(loss, metrics, gradients): ``lm_loss`` and its gradient by autograd,
    the gradients in ``params``' structure and types."""
    live = _live(params)
    loss, metrics = lm_loss(live, cfg, tokens, labels, frontend=frontend)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach(), metrics, _rebuild(params, grads, stacked=True)


def make_train_step(cfg: ArchConfig, optimizer: Optimizer, *, mesh=None,
                    axes: Sequence[str] = ("data",)) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with ``batch`` {"tokens", "labels"[, "frontend"]} (B, S) and
    metrics ``loss``, ``features`` (B, D) f32 and ``grad_norm`` (of the
    clipped gradients). With M = ``cfg.num_microbatches`` > 1 the batch is
    cut into M micro-batches of B / M rows, whose gradients are summed in
    f32 and divided by M, as are their losses."""
    m_count = max(1, cfg.num_microbatches)
    axes = tuple(axes)

    def train_step(params: PyTree, opt_state, batch: dict):
        tokens, labels = batch["tokens"], batch["labels"]
        frontend = batch.get("frontend")
        b = tokens.shape[0]
        if m_count == 1:
            loss, metrics, grads = loss_and_grads(cfg, params, tokens, labels, frontend)
            features = metrics["features"]
        else:
            if b % m_count:
                raise ValueError(f"batch {b} does not split into {m_count} micro-batches")
            mb = b // m_count
            grads = _rebuild(params, [torch.zeros_like(p, dtype=torch.float32)
                                      for p in tree_leaves(params)])
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            feats = []
            for i in range(m_count):
                rows = slice(i * mb, (i + 1) * mb)
                fr = None if frontend is None else frontend[rows]
                loss_i, met_i, g_i = loss_and_grads(cfg, params, tokens[rows], labels[rows], fr)
                for acc, g in zip(tree_leaves(grads), tree_leaves(g_i)):
                    acc.add_(g.float())
                loss = loss + loss_i
                feats.append(met_i["features"])
            grads = _rebuild(params, [g / m_count for g in tree_leaves(grads)])
            loss = loss / m_count
            features = torch.cat(feats)
        if mesh is not None and mesh.size(axes) > 1:
            n = mesh.size(axes)
            grads = _rebuild(params, [mesh.all_reduce(g, axes) / n for g in tree_leaves(grads)])
            loss = mesh.all_reduce(loss, axes) / n
        grads = clip_by_global_norm(grads, 1.0)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, "features": features,
                                     "grad_norm": global_norm(grads)}

    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    def prefill_step(params, batch):
        logits, caches, features = prefill(params, cfg, batch["tokens"],
                                           frontend=batch.get("frontend"))
        return {"logits": logits, "caches": caches, "features": features}

    return prefill_step


def make_decode_step(cfg: ArchConfig, max_seq: int) -> Callable:
    def serve_step(params, token, caches, pos, enc_out=None):
        return decode_step(params, cfg, token, caches, pos, enc_out=enc_out, max_seq=max_seq)

    return serve_step


# ------------------------------------------------- the paper's program


def make_detector_step(mesh, axes: Sequence[str] = ("data",), *, merge: bool = True,
                       ridge: float = 1e-3) -> Callable:
    """``detector_step(state, feats) -> state``: this rank's OS-ELM state
    stepped on its block ``feats`` (k, D) of the feature stream (x = t, the
    autoencoder), then, with ``merge``, merged with every rank's over
    ``axes``: U and V all-reduced once each, P and β recovered by Cholesky.
    Every rank ends with the same state."""
    axes = tuple(axes)

    def detector_step(state: OSELMState, feats: torch.Tensor) -> OSELMState:
        state = oselm_step(state, feats, feats)                   # Eq. 12, batch k
        if merge:
            uv = to_uv(state, ridge=ridge)
            merged = UV(u=mesh.all_reduce(uv.u, axes), v=mesh.all_reduce(uv.v, axes))  # Eq. 8
            state = from_uv(state, merged, ridge=ridge)
        return state

    return detector_step
