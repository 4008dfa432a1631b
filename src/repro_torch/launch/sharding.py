"""Divisibility-aware sharding rules; port of ``repro.launch.sharding``.

The rules are the reference's, keyed by leaf parameter name: the
contraction-free ("output") dim of each matmul weight goes on "model", the
d_model dim on "data", and a dim is sharded only where its size divides
by the axis's. They return the port's ``PartitionSpec``: one entry a
dimension, each None, an axis name or a tuple of names, as jax's.

A mesh here is anything with a ``shape`` mapping of axis names to sizes
(``repro_torch.launch.mesh.Mesh``). Where the reference places an array
on its mesh, the port gives each rank its block: ``shard_fleet`` takes
this rank's contiguous block of a stacked fleet (device d lives on shard
d // L, as in the reference) onto its device, and ``unshard_fleet``
gathers the blocks back, the counterpart of reading a global array. The
port's fleet keeps one shared (n, Ñ) basis where the reference stacks D
copies of it, so the basis is replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core import OSELMState

__all__ = [
    "NamedSharding", "PartitionSpec", "RULES", "batch_specs", "cache_specs_sharding",
    "fleet_shardings", "fleet_stack_spec", "opt_state_specs", "param_shardings",
    "param_specs", "shard_fleet", "spec_for_leaf", "unshard_fleet",
]

PyTree = Any


class PartitionSpec(tuple):
    """One entry a dimension: None (replicated), an axis name, or a tuple of
    axis names the dimension is split over, row-major. A tuple of one name
    is that name, as in jax."""

    def __new__(cls, *dims) -> "PartitionSpec":
        return super().__new__(cls, (d[0] if isinstance(d, tuple) and len(d) == 1 else d
                                     for d in dims))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec paired with the mesh it names axes of."""

    mesh: Any
    spec: PartitionSpec


# leaf-name → per-dim preferred axes (innermost dims; layer axis prepended)
RULES: dict[str, tuple] = {
    "embed": ("model", "data"),
    # attention
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    # dense FFN
    "gate": ("data", "model"),
    "up": ("data", "model"),
    "down": ("model", "data"),
    # MoE
    "router": ("data", None),
    "w_gate": ("model", "data", None),
    "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
    # mamba
    "in_proj": ("data", "model"),
    "out_proj": ("model", "data"),
    "b_proj": ("data", None),
    "c_proj": ("data", None),
    "dt_proj": ("data", None),
    "d_skip": (None,),
    "dt_bias": (None,),
    "a_log": (None,),
    # mLSTM / sLSTM
    "w_gates": ("data", "model"),
    "r_gates": (None, None, None),
    "wf": ("data", None),
    "wi": ("data", None),
    "wo_gate": ("data", None),
    "bf": (None,), "bi": (None,), "bo": (None,),
    # frontend stub projection
    "frontend_proj": (None, "data"),
}


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(mesh.shape)


def spec_for_leaf(name: str, shape: tuple[int, ...], mesh) -> PartitionSpec:
    sizes = _axis_sizes(mesh)
    rule = RULES.get(name)
    if rule is None or len(shape) < len(rule):
        return P()
    # MoE expert weights: where the expert dim cannot shard over "model",
    # the per-expert FFN dim goes there instead (the reference's rule)
    if name in ("w_gate", "w_up", "w_down") and len(shape) >= 3:
        if "model" in sizes and shape[-3] % sizes["model"] != 0:
            rule = (None, "data", "model") if name != "w_down" else (None, "model", "data")
    lead = len(shape) - len(rule)  # leading (layer-stack) dims → None
    dims: list = [None] * lead
    for dim_size, axis in zip(shape[lead:], rule):
        ok = axis is not None and axis in sizes and dim_size % sizes[axis] == 0
        dims.append(axis if ok else None)
    return P(*dims)


def _map_with_name(fn, tree, name: str = ""):
    """``fn(name, leaf)`` over dicts, lists, tuples and NamedTuples, where
    ``name`` is the nearest enclosing dict key (the reference's rule)."""
    if isinstance(tree, PartitionSpec):
        return fn(name, tree)
    if isinstance(tree, dict):
        return {k: _map_with_name(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_name(fn, v, name) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_name(fn, v, name) for v in tree)
    return fn(name, tree)


def param_specs(params: PyTree, mesh) -> PyTree:
    """A spec for every leaf of ``params`` (anything with a ``shape``)."""
    return _map_with_name(lambda name, leaf: spec_for_leaf(name, tuple(leaf.shape), mesh), params)


def param_shardings(params: PyTree, mesh) -> PyTree:
    return _map_with_name(lambda _, spec: NamedSharding(mesh, spec), param_specs(params, mesh))


def fleet_stack_spec(axes: tuple[str, ...] = ("data",)) -> PartitionSpec:
    """The stacked fleet's leading device axis over the federation axes,
    every trailing dim replicated."""
    return P(tuple(axes))


def fleet_shardings(states: OSELMState, mesh, axes: tuple[str, ...] = ("data",)) -> OSELMState:
    """The shardings of a stacked fleet's leaves: β and P split their device
    axis over ``axes``; the shared basis is replicated."""
    stack, rep = NamedSharding(mesh, fleet_stack_spec(axes)), NamedSharding(mesh, P())
    return states.replace(params=type(states.params)(rep, rep), beta=stack, p=stack)


def shard_fleet(states: OSELMState, mesh, axes: tuple[str, ...] = ("data",)) -> OSELMState:
    """This rank's contiguous block of a stacked fleet, on its device."""
    lo, hi = mesh.block(states.beta.shape[0], axes, "n_devices")
    dev = mesh.device
    return states.replace(
        params=type(states.params)(*(x.to(dev) for x in states.params)),
        beta=states.beta[lo:hi].to(dev).contiguous(), p=states.p[lo:hi].to(dev).contiguous())


def unshard_fleet(local: OSELMState, mesh, axes: tuple[str, ...] = ("data",)) -> OSELMState:
    """Every rank's block gathered back into the whole stacked fleet, on
    this rank's device."""
    return local.replace(beta=mesh.all_gather(local.beta, axes),
                         p=mesh.all_gather(local.p, axes))


def opt_state_specs(opt_state, params_specs_tree: PyTree):
    """Adam's moments follow their parameter's spec; the step is replicated."""
    from repro_torch.optim import OptState

    mu = opt_state.mu and params_specs_tree
    nu = opt_state.nu and params_specs_tree
    return OptState(step=P(), mu=mu, nu=nu)


def batch_specs(batch_kind: str, dp_axes: tuple[str, ...], mesh, cfg=None) -> dict:
    """Input specs by shape kind: the batch dim on the data (and pod) axes."""
    if batch_kind not in ("train", "prefill"):
        raise ValueError(batch_kind)
    specs = {"tokens": P(dp_axes, None)}
    if batch_kind == "train":
        specs["labels"] = P(dp_axes, None)
    if cfg is not None and cfg.frontend is not None:
        specs["frontend"] = P(dp_axes, None, None)
    return specs


def cache_specs_sharding(caches: PyTree, mesh, dp_axes: tuple[str, ...], *,
                         shard_seq: bool = False) -> PyTree:
    """Decode caches: (L, B, S, KV, hd) attention caches and recurrent
    states (L, B, ...). The batch on the data axes; with ``shard_seq`` a
    batch-1 long-context cache puts its sequence dim there instead."""
    sizes = _axis_sizes(mesh)
    dp = int(np.prod([sizes[a] for a in dp_axes]))

    def visit(_, leaf):
        shp = tuple(leaf.shape)
        if len(shp) == 5:
            if shard_seq and shp[2] % dp == 0:
                return P(None, None, dp_axes, None, None)
            return P(None, dp_axes if shp[1] % dp == 0 else None, None, None, None)
        if len(shp) >= 2:
            return P(None, dp_axes if shp[1] % dp == 0 else None, *([None] * (len(shp) - 2)))
        return P()

    return _map_with_name(visit, caches)
