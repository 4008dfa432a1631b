"""Rank programs of the port's multi-process CPU tests
(``tests/test_torch_mesh.py``, ``test_torch_sharded.py``,
``test_torch_mesh_federation.py``, ``test_torch_train.py``). ``repro_torch.launch.mesh.spawn``
imports this module by name in every rank, so it imports numpy, torch and
``repro_torch`` only, never JAX or the reference: the tests hand their
inputs over as numpy arrays and hold what the ranks return to the
reference in the parent process.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.convert import oselm_state_from_numpy


def _state(leaves: dict, device="cpu"):
    return oselm_state_from_numpy(leaves["alpha"], leaves["bias"], leaves["beta"], leaves["p"],
                                  activation=leaves["activation"], forget=leaves["forget"],
                                  device=device)


def _np(state) -> dict:
    return {"beta": state.beta.cpu().numpy(), "p": state.p.cpu().numpy()}


# ------------------------------------------------------------------ mesh


def mesh_checks(rank: int) -> dict:
    """The mesh on a world of 4: a (2, 2) mesh's coordinates, groups and
    collectives, a (4, 1) host mesh's ring and gather, the production
    mesh's refusal, the sharded fleet's blocks."""
    from repro_torch.launch.mesh import Mesh, data_axes, make_host_mesh, make_production_mesh
    from repro_torch.launch.sharding import shard_fleet, unshard_fleet

    out = {}
    grid = Mesh((2, 2), ("data", "model"))
    out["grid_coords"] = grid.coords
    x = torch.full((3,), float(rank + 1))
    out["sum_data"] = grid.all_reduce(x, ("data",)).numpy()
    out["sum_model"] = grid.all_reduce(x, "model").numpy()
    out["sum_both"] = grid.all_reduce(x, ("data", "model")).numpy()
    out["gather_data"] = grid.all_gather(x[None], ("data",)).numpy()
    out["gather_both"] = grid.all_gather(x[None], ("model", "data")).numpy()
    out["index_md"] = grid.index(("model", "data"))
    out["ring2"] = [t.numpy() for t in grid.ring_exchange(x[None] * 10, x[None] * 100, "data")]

    host = make_host_mesh()
    out["host_shape"] = dict(host.shape)
    out["data_axes"] = data_axes(host)
    out["ring4"] = [t.numpy() for t in host.ring_exchange(x[None] * 10, x[None] * 100)]
    out["stats"] = (host.stats.calls, host.stats.bytes, host.stats.staged_bytes)
    try:
        make_production_mesh()
    except RuntimeError as e:
        out["production"] = str(e)
    fleet = oselm_state_from_numpy(np.ones((3, 2), np.float32), np.zeros(2, np.float32),
                                   np.arange(8 * 2 * 3, dtype=np.float32).reshape(8, 2, 3),
                                   np.arange(8 * 4, dtype=np.float32).reshape(8, 2, 2),
                                   activation="identity", forget=1.0, device="cpu")
    local = shard_fleet(fleet, host)
    out["block"] = _np(local)
    out["unsharded"] = _np(unshard_fleet(local, host))
    try:
        shard_fleet(fleet.replace(beta=fleet.beta[:6], p=fleet.p[:6]), host)
    except ValueError as e:
        out["indivisible"] = str(e)
    out["backend"] = host.backend
    out["threads"] = torch.get_num_threads()
    out["loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    return out


def failing_rank(rank: int) -> None:
    if rank == 1:
        raise ArithmeticError("rank 1 fails on purpose")
    torch.distributed.barrier()


def hanging_rank(rank: int, seconds: float) -> None:
    if rank == 1:
        import time

        time.sleep(seconds)


# --------------------------------------------------------------- sharded


def sharded_checks(rank: int, fleet: dict, streams: np.ndarray, trained: dict, topologies: dict,
                   hops: tuple[int, ...], ridge: float, cohort: dict) -> dict:
    """Every sharded path on one group: training, the psum merge on each
    topology, the halo at each ``hops`` and one past a shard, the cohort
    tier 2 and ``CohortMerger(mesh=)``. Returns this rank's blocks."""
    from repro_torch.fleet import (
        CohortMerger,
        CohortSchedule,
        FleetArena,
        all_to_all,
        cohort_tree_reduce,
        fleet_merge_sharded,
        fleet_train_sharded,
        hierarchical,
        ring,
        star,
    )
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import shard_fleet

    makers = {"all_to_all": all_to_all, "star": star,
              "hierarchical": lambda d, c: hierarchical(d, c),
              "hierarchical_isolated": lambda d, c: hierarchical(d, c, head_exchange=False)}
    mesh = make_host_mesh()
    d = fleet["beta"].shape[0]
    out = {"rank": rank, "index": mesh.index(("data",))}
    out["trained"] = _np(fleet_train_sharded(shard_fleet(_state(fleet), mesh), streams, mesh))
    local = shard_fleet(_state(trained), mesh)
    out["merged"] = {}
    for name, args in topologies.items():
        mesh.reset_stats()
        out["merged"][name] = _np(fleet_merge_sharded(local, makers[name](d, *args), mesh,
                                                      ridge=ridge))
        out["merged"][name]["wire_bytes"] = mesh.stats.bytes
    out["halo"] = {}
    for h in hops:
        mesh.reset_stats()
        out["halo"][h] = _np(fleet_merge_sharded(local, ring(d, h), mesh, ridge=ridge))
        out["halo"][h]["wire_bytes"] = mesh.stats.bytes
    try:
        fleet_merge_sharded(local, ring(d, d // mesh.size("data") + 1), mesh, ridge=ridge)
    except ValueError as e:
        out["halo_error"] = str(e)

    parts = torch.from_numpy(cohort["partials"])
    out["tree"] = cohort_tree_reduce(parts, mesh).numpy()
    try:
        cohort_tree_reduce(parts[:-1], mesh)
    except ValueError as e:
        out["tree_error"] = str(e)
    merged = {}
    for use_mesh in (False, True):
        arena = FleetArena.from_fleet(_state(trained))
        merger = CohortMerger(star(d), CohortSchedule(d, cohort["size"]), ridge=ridge,
                              mesh=mesh if use_mesh else None, device="cpu")
        merger.merge(arena, cohort["mask"])
        merged[use_mesh] = {"p": arena.p.numpy().copy(), "beta": arena.beta.numpy().copy(),
                            "launches": merger.launches_per_round()}
    out["cohort"] = merged
    return out


# ------------------------------------------------------- mesh federation


def federation_checks(rank: int, devices: list[dict], streams: np.ndarray, ridge: float,
                      merge_every: int) -> dict:
    """``mesh_cooperative_update`` of this rank's device trained on its
    stream (a block of one), then ``mesh_federated_train`` of its boot
    state on every shard's streams with ``merge_every``."""
    from repro_torch.core import oselm_train_sequential
    from repro_torch.federated import mesh_cooperative_update, mesh_federated_train
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh()
    boot = _state(devices[rank])
    xs = torch.from_numpy(streams[rank])
    trained = oselm_train_sequential(boot, xs, xs)
    stacked = trained.replace(beta=trained.beta[None], p=trained.p[None])
    one_shot = mesh_cooperative_update(stacked, mesh, ridge=ridge)
    chain = mesh_federated_train(boot, streams, mesh, merge_every=merge_every, ridge=ridge)
    return {"one_shot": _np(one_shot), "chain": _np(chain)}


# ------------------------------------------------------------ training


def step_checks(rank: int, state: dict, feats: np.ndarray, ridge: float, arch: str,
                batch: dict) -> dict:
    """``launch.steps.make_detector_step`` on this rank's block of ``feats``
    (shards, k, D), without the merge and with it; then one
    ``make_train_step(mesh=)`` sgd step of the reduced ``arch`` on this
    rank's block of ``batch``, its gradients averaged over the ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import data_axes, make_host_mesh
    from repro_torch.launch.steps import make_detector_step, make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import sgd, tree_leaves

    mesh = make_host_mesh()
    axes = data_axes(mesh)
    x = torch.from_numpy(feats[mesh.index(axes)])
    start = _state(state)
    alone = make_detector_step(mesh, axes, merge=False, ridge=ridge)(start, x)
    merged = make_detector_step(mesh, axes, merge=True, ridge=ridge)(start, x)
    calls = mesh.stats.calls
    cfg = get_config(arch).reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    lo, hi = mesh.block(len(batch["tokens"]), axes)
    step = make_train_step(cfg, sgd(0.5), mesh=mesh, axes=axes)
    params, _, met = step(params, sgd(0.5).init(params),
                          {k: torch.from_numpy(v[lo:hi]) for k, v in batch.items()})
    return {"alone": _np(alone), "merged": _np(merged), "calls": calls,
            "loss": float(met["loss"]), "params": [t.numpy() for t in tree_leaves(params)]}
