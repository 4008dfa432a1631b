"""Optimizers over parameter trees; port of ``repro.optim.optimizers``:
``adam`` (with a callable learning rate, moments kept in a narrower type,
and weight decay), ``adamw``, ``sgd`` with and without momentum, and
``clip_by_global_norm``. They serve the BP-NN baselines and the model
zoo's training step (``repro_torch.launch.steps``).

A tree is a tensor, or a list, tuple or dict of trees (the BP-NN
parameters are a list of {"w", "b"} dicts, a model's a nested dict). The
updates are functional, as the reference's: they return new tensors and
leave their inputs alone. Types follow jnp's promotion where torch's
differs:

- the moments are updated in the gradient's type (jnp's weak Python
  scalars keep it), so a bf16 gradient keeps bf16 moments, then cast to
  ``moment_dtype`` after the update (``_cast_like``);
- the bias corrections 1 − bᵗ are f32 arrays, not weak scalars, so m̂, v̂
  and the step are f32 whatever the moments' type (torch would keep a
  bf16 tensor divided by a 0-d f32 tensor in bf16);
- the new parameter is (p − Δ) in f32, cast back to p's type;
- clipping scales each gradient in f32 and casts it back.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

Tree = Any

__all__ = ["OptState", "Optimizer", "adam", "adamw", "clip_by_global_norm", "global_norm",
           "sgd", "tree_leaves", "tree_map"]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """The leaves in the reference's order (``jax.tree.leaves``: a dict's
    keys sorted), so that sums over the leaves add in its order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [] if tree is None else [tree]


class OptState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


class Optimizer(NamedTuple):
    init: Callable[[Tree], OptState]
    update: Callable[[Tree, OptState, Tree], tuple[Tree, OptState]]


def _cast_like(tree: Tree, dtype: torch.dtype | None) -> Tree:
    return tree if dtype is None else tree_map(lambda x: x.to(dtype), tree)


def _f32_power(b: float, step: int) -> float:
    """1 − bᵗ in f32, as the reference's ``1 - b ** step.astype(f32)``."""
    t = torch.tensor(float(step), dtype=torch.float32)
    return float(1 - torch.tensor(b, dtype=torch.float32) ** t)


def adam(
    lr: float | Callable[[int], float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    *,
    moment_dtype: torch.dtype | None = None,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Adam; ``lr`` a number or a function of the step (from 1);
    ``moment_dtype=torch.bfloat16`` halves the optimizer's memory;
    ``weight_decay`` adds lr·wd·p to the step (decoupled, as AdamW)."""

    def init(params: Tree) -> OptState:
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=moment_dtype or p.dtype), params)
        return OptState(step=0, mu=zeros, nu=tree_map(torch.clone, zeros))

    def update(grads: Tree, state: OptState, params: Tree) -> tuple[Tree, OptState]:
        step = int(state.step) + 1
        lr_t = lr(step) if callable(lr) else lr
        mu = tree_map(lambda m, g: b1 * m.to(g.dtype) + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v.to(g.dtype) + (1 - b2) * g * g, state.nu, grads)
        bc1, bc2 = _f32_power(b1, step), _f32_power(b2, step)

        def upd(p, m, v):
            delta = lr_t * (m.float() / bc1) / (torch.sqrt(v.float() / bc2) + eps)
            if weight_decay:
                delta = delta + lr_t * weight_decay * p.float()
            return (p.float() - delta).to(p.dtype)

        return tree_map(upd, params, mu, nu), OptState(
            step=step, mu=_cast_like(mu, moment_dtype), nu=_cast_like(nu, moment_dtype))

    return Optimizer(init=init, update=update)


def adamw(lr, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params: Tree) -> OptState:
        mu = tree_map(torch.zeros_like, params) if momentum else None
        return OptState(step=0, mu=mu, nu=None)

    def update(grads: Tree, state: OptState, params: Tree) -> tuple[Tree, OptState]:
        step = int(state.step) + 1
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state.mu, grads)
            new = tree_map(lambda p, m: (p - lr * m).to(p.dtype), params, mu)
            return new, OptState(step=step, mu=mu, nu=None)
        new = tree_map(lambda p, g: (p - lr * g).to(p.dtype), params, grads)
        return new, OptState(step=step, mu=None, nu=None)

    return Optimizer(init=init, update=update)


def global_norm(grads: Tree) -> torch.Tensor:
    """√(Σ g²) over every leaf, in f32, the leaves summed in the
    reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    scale = torch.clamp(max_norm / (global_norm(grads) + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)
