"""Adam over parameter trees; port of ``repro.optim.optimizers.adam``,
the one optimizer the BP-NN baselines need.

A tree is a tensor, or a list, tuple or dict of trees (the BP-NN
parameters are a list of {"w", "b"} dicts). The update is functional, as
the reference's: it returns new tensors and leaves its inputs alone. The
arithmetic is the reference's, in f32: the bias corrections 1 − bᵗ are
f32 powers, and the step is lr·m̂ / (√v̂ + ε).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    return fn(tree, *rest)


class OptState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


class Optimizer(NamedTuple):
    init: Callable[[Tree], OptState]
    update: Callable[[Tree, OptState, Tree], tuple[Tree, OptState]]


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params: Tree) -> OptState:
        return OptState(step=0, mu=tree_map(torch.zeros_like, params),
                        nu=tree_map(torch.zeros_like, params))

    def update(grads: Tree, state: OptState, params: Tree) -> tuple[Tree, OptState]:
        step = state.step + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        t = torch.tensor(float(step), dtype=torch.float32)
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)

        def upd(p, m, v):
            return p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)

        return tree_map(upd, params, mu, nu), OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)
