"""The paper's cooperative model update as a collective across processes;
port of ``repro.federated.mesh_federation`` on ``torch.distributed``.

E²LM's merge (Eq. 8) is a sum of per-device sufficient statistics, so a
federation of N edge devices maps to N ranks of a ``Mesh``
(``repro_torch.launch.mesh``), one fleet device a rank, whose (U, V) are
combined with one ``all_reduce`` each over the federation axes: the
paper's one-shot cooperative update as a single all-reduce instead of
uploads to a parameter server.

Each rank:
  1. trains its own OS-ELM autoencoder on its local (non-IID) stream, one
     sample at a time (``oselm_train_sequential``, the fused ingest);
  2. computes (U, V) by Eq. 15 (``to_uv``) when a merge is due;
  3. all-reduces U and V over the axes;
  4. recovers P ← (U+εI)⁻¹ and β ← (U+εI)⁻¹V by Cholesky (``from_uv``), as
     the reference does: every rank ends with the same model, bit for bit.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.core import UV, OSELMState, from_uv, oselm_train_sequential, to_uv

__all__ = ["mesh_cooperative_update", "mesh_federated_train"]


def _unstacked(states: OSELMState) -> tuple[OSELMState, bool]:
    """This rank's one device, from a block of one (the stacked fleet
    sharded one device a rank) or a single state."""
    if states.beta.ndim == 3:
        if states.beta.shape[0] != 1:
            raise ValueError(f"one fleet device a rank; this rank holds {states.beta.shape[0]}")
        return states.replace(beta=states.beta[0], p=states.p[0]), True
    return states, False


def _restacked(state: OSELMState, stacked: bool) -> OSELMState:
    return state.replace(beta=state.beta[None], p=state.p[None]) if stacked else state


def _merge(state: OSELMState, mesh, axes: tuple[str, ...], ridge: float) -> OSELMState:
    uv = to_uv(state, ridge=ridge)
    merged = UV(u=mesh.all_reduce(uv.u, axes), v=mesh.all_reduce(uv.v, axes))  # Eq. 8
    return from_uv(state, merged, ridge=ridge)


def mesh_cooperative_update(
    states: OSELMState, mesh, axes: Sequence[str] = ("data",), *, ridge: float = 0.0
) -> OSELMState:
    """The one-shot federated merge of every rank's state: ``states`` is this
    rank's device (a block of one, or a single state); returns the merged
    state in the same form, the same on every rank."""
    state, stacked = _unstacked(states)
    return _restacked(_merge(state, mesh, tuple(axes), ridge), stacked)


def mesh_federated_train(
    states: OSELMState,
    streams,
    mesh,
    axes: Sequence[str] = ("data",),
    *,
    merge_every: int | None = None,
    ridge: float = 0.0,
) -> OSELMState:
    """Train this rank's device on its local stream, then merge
    cooperatively. ``streams`` is every shard's (shards, steps, features),
    of which the rank takes its own. With ``merge_every`` the stream
    is cut into chunks of that many samples (a tail shorter than a chunk is
    dropped) and a cooperative update follows every chunk, the paper's
    "repeatedly applied to synchronize" mode; otherwise one merge ends the
    stream."""
    axes = tuple(axes)
    state, stacked = _unstacked(states)
    xs = torch.as_tensor(np.asarray(streams, np.float32) if not isinstance(streams, torch.Tensor)
                         else streams, dtype=torch.float32, device=state.p.device)
    if xs.ndim != 3 or xs.shape[0] != mesh.size(axes):
        raise ValueError(f"need streams (shards={mesh.size(axes)}, steps, features); got "
                         f"{tuple(xs.shape)}")
    xs = xs[mesh.index(axes)]
    if merge_every is None:
        chunks = [xs]
    else:
        if merge_every < 1:
            raise ValueError(f"merge_every must be >= 1; got {merge_every}")
        n_chunks = xs.shape[0] // merge_every
        chunks = [xs[c * merge_every : (c + 1) * merge_every] for c in range(n_chunks)]
    for chunk in chunks:
        chunk = chunk.contiguous()
        state = _merge(oselm_train_sequential(state, chunk, chunk), mesh, axes, ridge)
    return _restacked(state, stacked)
