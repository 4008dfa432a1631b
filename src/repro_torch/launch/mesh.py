"""Device meshes over ``torch.distributed``; port of ``repro.launch.mesh``.

In the reference a mesh is one process's view of many devices. Here one
rank is one process on one device, and a ``Mesh`` lays the initialised
world's ranks out in row-major order over named axes:

- its axis names, its shape and this rank's coordinates;
- one process group per tuple of axes, made by every rank at
  construction in the same order (a tuple of axes of size 1 in a larger
  world needs no group: a collective over it is the identity);
- its backend, fixed at construction from the ranks' devices: ``nccl``
  where each rank owns a card of its own, ``gloo`` where the ranks share
  a card or run on the CPU. Nothing switches backend after a failure;
- this rank's device.

Its collectives (``all_reduce``, ``all_gather``, ``ring_exchange``) take
and return tensors on the rank's device. Under gloo a CUDA operand is
staged explicitly through a pinned host buffer (copied down, reduced or
sent there, copied back up); ``mesh.stats`` counts the calls, the bytes
each rank put on the wire, the bytes staged and the time spent, read
off CUDA events on the card so that no collective drains the device.

``spawn`` runs a function on n ranks, each a process started with the
``spawn`` method, with a ``FileStore`` rendezvous in a directory the
caller gives, and joins them under a timeout: a rank that fails or hangs
fails the call, and no rank is left running. Every multi-process run of
the port (its tests, ``benchmarks/torch_mesh_merge.py``, ``chip_smoke.py``)
goes through it.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import logging
import math
import multiprocessing
import os
import pickle
import time
import traceback
import uuid
from collections.abc import Callable, Sequence
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "backend_for", "data_axes", "make_host_mesh", "make_production_mesh",
           "rank_device", "spawn"]

log = logging.getLogger(__name__)

# the reference's production meshes (launch/mesh.py): one pod of 256
# chips, or two pods; the "pod" axis is pure data parallelism
PRODUCTION = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def rank_device(kind: str, rank: int, world_size: int) -> torch.device:
    """Rank ``rank``'s device: the CPU, its own card where the machine has
    a card for every rank, else card 0, shared by every rank."""
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"device kind must be 'cpu' or 'cuda'; got {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu'")
    return torch.device("cuda", rank if torch.cuda.device_count() >= world_size else 0)


def backend_for(kind: str, world_size: int) -> str:
    """``nccl`` where each rank owns a card of its own, else ``gloo``."""
    if kind == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


@dataclasses.dataclass
class CollectiveStats:
    """What this rank's collectives cost since the last reset. The time is
    read off the card's stream (a CUDA event before and after each
    collective, staging included) or the host clock on the CPU, so taking
    it drains nothing; ``seconds`` waits for the last collective's end."""

    calls: int = 0
    bytes: int = 0         # bytes this rank put on the wire (its operands)
    staged_bytes: int = 0  # bytes copied between the card and pinned host buffers
    done_seconds: float = 0.0  # finished collectives: host clock, or the card's folded events
    events: list = dataclasses.field(default_factory=list)  # (start, end) on the card

    def fold(self) -> None:
        """Fold the collectives the card has finished into ``done_seconds``
        (without waiting), so that the list of events stays short."""
        while self.events and self.events[0][1].query():
            start, end = self.events.pop(0)
            self.done_seconds += start.elapsed_time(end) / 1e3

    @property
    def seconds(self) -> float:
        for _, end in self.events[-1:]:
            end.synchronize()
        self.fold()
        return self.done_seconds


class Mesh:
    """The initialised world's ranks over named axes, row-major (the last
    axis varies fastest, as in ``np.arange(world).reshape(shape)``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device: str | torch.device | None = None) -> None:
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised; start the ranks with "
                               "repro_torch.launch.mesh.spawn or init_process_group")
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"need one distinct name an axis; got {axis_names} for {shape}")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} has {math.prod(shape)} "
                             f"ranks; the world has {world}")
        self.axis_names = axis_names
        self.devices_shape = shape
        self.shape = dict(zip(axis_names, shape))
        self.rank = dist.get_rank()
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(self.rank, shape))))
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend() == "nccl" else _spawned_device())
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        want = backend_for(self.device.type, world)
        if self.backend != want:
            raise ValueError(f"ranks on {self.device.type} over {world} ranks take {want}; "
                             f"the world was initialised with {self.backend}")
        self.stats = CollectiveStats()
        self._ranks = np.arange(world).reshape(shape)
        self._groups: dict[tuple[str, ...], object] = {}
        for r in range(1, len(axis_names) + 1):  # every rank, in the same order
            for axes in itertools.combinations(axis_names, r):
                self._groups[axes] = self._make_group(axes)
        self._pinned: dict[tuple, torch.Tensor] = {}
        log.info("mesh %s: rank %d at %s on %s over %s", self.shape, self.rank, self.coords,
                 self.device, self.backend)

    def _make_group(self, axes: tuple[str, ...]):
        size = self.size(axes)
        if size == self._ranks.size:  # a world of one rank too: its backend runs
            return dist.group.WORLD
        if size == 1:  # no group: every collective over it is the identity
            return None
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in idx]
        rows = np.transpose(self._ranks, rest + idx).reshape(-1, size)
        mine = None
        for row in rows:
            g = dist.new_group(ranks=row.tolist())
            if self.rank in row:
                mine = g
        return mine

    # ------------------------------------------------------------ layout

    def _axes(self, axes: Sequence[str]) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} are not distinct axes of {self.axis_names}")
        return axes

    def size(self, axes: Sequence[str]) -> int:
        """The number of shards over ``axes``."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes: Sequence[str]) -> int:
        """This rank's shard over ``axes``: its coordinates on them,
        row-major in the order given (a stacked axis sharded over them puts
        its block ``index`` here)."""
        axes = self._axes(axes)
        return int(np.ravel_multi_index([self.coords[a] for a in axes],
                                        [self.shape[a] for a in axes]))

    def block(self, n: int, axes: Sequence[str] = ("data",), what: str = "n") -> tuple[int, int]:
        """This rank's contiguous block [lo, hi) of a stacked axis of ``n``
        entries sharded over ``axes`` (entry i lives on shard i // (n /
        shards)); raises where ``n`` does not divide by the shards."""
        shards = self.size(axes)
        if n % shards:
            raise ValueError(f"{what}={n} not divisible by {shards} mesh shards")
        per = n // shards
        lo = self.index(axes) * per
        return lo, lo + per

    def group(self, axes: Sequence[str]):
        key = tuple(a for a in self.axis_names if a in self._axes(axes))
        return self._groups[key]

    def _shard_ranks(self, axes: tuple[str, ...]) -> list[int]:
        """The global ranks of this rank's group over ``axes``, by shard."""
        out = []
        for shard in range(self.size(axes)):
            coords = dict(self.coords)
            for a, c in zip(axes, np.unravel_index(shard, [self.shape[a] for a in axes])):
                coords[a] = int(c)
            out.append(int(self._ranks[tuple(coords[a] for a in self.axis_names)]))
        return out

    # ------------------------------------------------------- collectives

    def _staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _host(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        """A pinned host buffer shaped as ``t`` (kept for the next call)."""
        key = (slot, tuple(t.shape), t.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf

    def _down(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        """``t`` as the backend takes it: a pinned host copy under gloo with
        a CUDA tensor, else a private copy on its device."""
        if not self._staged():
            return t.clone()
        buf = self._host(t, slot)
        buf.copy_(t)
        self.stats.staged_bytes += t.nbytes
        return buf

    def _up(self, buf: torch.Tensor) -> torch.Tensor:
        """A host result back on the card (counted), or the result as it is."""
        if not self._staged():
            return buf
        self.stats.staged_bytes += buf.nbytes
        return buf.to(self.device)

    def _start(self):
        """A mark at a collective's start: an event on the card's stream, or
        the host clock."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _done(self, start, nbytes: int) -> None:
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.stats.events.append((start, end))
            if len(self.stats.events) > 64:
                self.stats.fold()
        else:
            self.stats.done_seconds += time.perf_counter() - start
        self.stats.calls += 1
        self.stats.bytes += nbytes

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str] = ("data",)) -> torch.Tensor:
        """The sum of ``t`` over the shards of ``axes`` (``psum``), a new
        tensor, the same on every rank of the group."""
        group = self.group(axes)
        if group is None:
            return t.clone()
        start = self._start()
        buf = self._down(t.contiguous(), "reduce")
        dist.all_reduce(buf, group=group)
        out = self._up(buf)
        self._done(start, t.nbytes)
        return out

    def all_gather(self, t: torch.Tensor, axes: Sequence[str] = ("data",)) -> torch.Tensor:
        """Every shard's ``t`` over ``axes``, concatenated along axis 0 in
        shard order."""
        axes = self._axes(axes)
        group = self.group(axes)
        if group is None:
            return t.clone()
        start = self._start()
        buf = self._down(t.contiguous(), "gather")
        parts = [torch.empty_like(buf) for _ in range(self.size(axes))]
        dist.all_gather(parts, buf, group=group)
        # the group lists its ranks in ascending global order; take them by shard
        order = sorted(self._shard_ranks(axes))
        by_rank = dict(zip(order, parts))
        out = self._up(torch.cat([by_rank[r] for r in self._shard_ranks(axes)]))
        self._done(start, t.nbytes)
        return out

    def ring_exchange(self, to_next: torch.Tensor, to_prev: torch.Tensor,
                      axis: str = "data") -> tuple[torch.Tensor, torch.Tensor]:
        """``ppermute`` both ways around the ring of ``axis``: send
        ``to_next`` to the next shard and ``to_prev`` to the previous one
        (wrapping), and return what the previous shard sent forward and
        what the next one sent back. One batch of sends and receives."""
        (axis,) = self._axes((axis,))
        n = self.shape[axis]
        if n == 1:  # the ring of one shard maps it onto itself
            return to_next.clone(), to_prev.clone()
        start = self._start()
        shard = self.coords[axis]
        ranks = self._shard_ranks((axis,))
        nxt, prv = ranks[(shard + 1) % n], ranks[(shard - 1) % n]
        send_next, send_prev = self._down(to_next, "next"), self._down(to_prev, "prev")
        from_prev = torch.empty_like(send_next)
        from_next = torch.empty_like(send_prev)
        ops = [dist.P2POp(dist.isend, send_next, nxt, tag=0),
               dist.P2POp(dist.isend, send_prev, prv, tag=1),
               dist.P2POp(dist.irecv, from_prev, prv, tag=0),
               dist.P2POp(dist.irecv, from_next, nxt, tag=1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = self._up(from_prev), self._up(from_next)
        self._done(start, to_next.nbytes + to_prev.nbytes)
        return out

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def reset_stats(self) -> None:
        self.stats = CollectiveStats()


# ------------------------------------------------------------- meshes


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production mesh: (16, 16) = ("data", "model"), or
    (2, 16, 16) = ("pod", "data", "model"). It needs a world of 256 or 512
    ranks."""
    shape, axes = PRODUCTION[multi_pod]
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise RuntimeError(f"the production mesh {dict(zip(axes, shape))} needs {need} ranks; "
                           f"the world has {world}")
    return Mesh(shape, axes, device=device)


def make_host_mesh(n_data: int | None = None, n_model: int = 1, *, device=None) -> Mesh:
    """A ("data", "model") mesh over the initialised world."""
    n = dist.get_world_size()
    n_data = n_data or n // n_model
    return Mesh((n_data, n_model), ("data", "model"), device=device)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The federation and batch axes: ("pod", "data") on multi-pod meshes."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


# ------------------------------------------------------------- spawning

_DEVICE_ENV = "REPRO_TORCH_RANK_DEVICE"


def _spawned_device() -> torch.device:
    """The device ``spawn`` gave this rank (the CPU outside a spawned rank)."""
    return torch.device(os.environ.get(_DEVICE_ENV, "cpu"))


def _rank_main(fn, rank: int, n: int, store: str, kind: str, args: tuple, out: str,
               timeout: float) -> None:
    try:
        if kind == "cpu":
            torch.set_num_threads(1)
        device = rank_device(kind, rank, n)
        os.environ[_DEVICE_ENV] = str(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend_for(kind, n), store=dist.FileStore(store, n), rank=rank,
                                world_size=n, timeout=datetime.timedelta(seconds=timeout))
        try:
            result = ("ok", fn(rank, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the call
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    if result[0] == "error":
        raise SystemExit(1)


def spawn(fn: Callable, n_ranks: int, rendezvous_dir: str | os.PathLike, *,
          device: str = "cuda", args: tuple = (), timeout: float = 120.0) -> list:
    """Run ``fn(rank, *args)`` on ``n_ranks`` ranks and return their results
    in rank order. Each rank is a process started with the ``spawn``
    method (``fn`` and ``args`` are pickled: ``fn`` must be importable by
    its module's name), initialises ``torch.distributed`` from a
    ``FileStore`` in ``rendezvous_dir`` with the backend of its devices
    (``backend_for``), sets one thread on the CPU, and runs ``fn``. A rank
    that raises fails the call with its traceback; ranks still running
    ``timeout`` seconds after the start fail it too. Either way every rank
    is stopped before this returns. On the card the kernels are built here
    first, so the ranks load the parent's library."""
    if device == "cuda":
        from repro_torch.kernels import _lib

        rank_device(device, 0, n_ranks)  # raises without a card
        _lib.library()
    root = Path(rendezvous_dir)
    root.mkdir(parents=True, exist_ok=True)
    tag = uuid.uuid4().hex
    store = root / f"store-{tag}"
    outs = [root / f"rank{r}-{tag}.pkl" for r in range(n_ranks)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, name=f"repro-rank{r}",
                         args=(fn, r, n_ranks, str(store), device, args, str(outs[r]), timeout))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                break
            if time.monotonic() > deadline:
                hung = [r for r, p in enumerate(procs) if p.is_alive()]
                raise TimeoutError(f"ranks {hung} of {n_ranks} still ran after {timeout:.0f} s")
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
    results, errors = [], []
    for r, (p, out) in enumerate(zip(procs, outs)):
        if out.exists():
            with open(out, "rb") as f:
                status, value = pickle.load(f)  # written by the rank above
            out.unlink()
        else:
            status, value = "error", f"exit code {p.exitcode}, no result"
        if status == "ok":
            results.append(value)
        else:
            errors.append(f"rank {r}: {value}")
    store.unlink(missing_ok=True)
    if errors:
        raise RuntimeError(f"{len(errors)} of {n_ranks} ranks failed:\n" + "\n".join(errors))
    return results
