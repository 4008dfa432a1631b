"""Host-side fleet arena, cohort schedule and the two-tier cohort merge;
port of ``repro.fleet.arena``.

The resident runtime keeps the whole stacked fleet on the card, which caps
D at the card's memory. This module lifts that cap:

- ``FleetArena`` keeps each device's OS-ELM state (P, β) in host memory as
  (D, Ñ, Ñ) and (D, Ñ, m) f32 tensors, and the shared random basis (α, b)
  once. ``page(lo, hi)`` views a cohort's rows with no copy, as an
  ``OSELMState`` over the one (n, Ñ) basis. At Ñ = 4, m = 8 a million
  devices is 192 MB of host memory.
- ``CohortSchedule`` says which contiguous block of devices is on the card
  when: D divides into equal cohorts, so every page has one shape.
- ``CohortMerger`` runs Eq. 8 as a two-tier tree, one page on the card at a
  time. Tier 1 is the page's masked segment sums of its (U, V) payloads
  (``masked_segment_sum_mix``); tier 2 folds the O(cohorts) partials
  (``repro_torch.fleet.sharded.cohort_tree_reduce``; over a mesh each rank
  reduces its own block of cohorts and one all-reduce joins them), or, on
  the open ring, takes each page's ±hops halo from its neighbours. Every solve is
  ``from_uv_solve``. Eq. 8 is a sum, so the tree reorders the adds and
  changes nothing else.
- ``cohort_round_cost`` splits a round's payloads by tier: tier 1 stays in
  a cohort, tier 2 crosses the cohort heads' overlay.

On a CUDA device the pages move through ``_Pager``: the arena's leaves are
pinned host memory, a page is copied to the card on a copy stream of its
own while the previous page computes, and each computed page is copied
back on another without blocking the host, ordered by events. A paged
loop waits for all its copies before it returns, so the host never reads
an arena row a copy still writes.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.elm import SLFNParams, init_slfn, invert_u
from repro_torch.core.oselm import OSELMState, init_oselm
from repro_torch.fleet.comm import payload_nbytes
from repro_torch.fleet.sharded import cohort_tree_reduce, mesh_tree_reduce
from repro_torch.fleet.topology import Topology
from repro_torch.kernels.topology_merge import from_uv_solve, masked_segment_sum_mix

__all__ = [
    "FleetArena",
    "CohortSchedule",
    "CohortMerger",
    "TierCost",
    "cohort_round_cost",
    "init_arena",
]


def _host_f32(x) -> torch.Tensor:
    """``x`` as a contiguous f32 host tensor, sharing memory where it can
    (a contiguous f32 numpy array or CPU tensor is taken as it is)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _host_copy(x) -> torch.Tensor:
    """A contiguous f32 host copy of ``x`` that shares nothing with it."""
    src = torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x.detach()
    return torch.empty(tuple(src.shape), dtype=torch.float32).copy_(src)


# ------------------------------------------------------------------ arena


@dataclasses.dataclass
class FleetArena:
    """Host-resident fleet state: the shared basis once, (P, β) per device."""

    alpha: torch.Tensor      # (n_features, Ñ) shared random basis
    bias: torch.Tensor       # (Ñ,)
    p: torch.Tensor          # (D, Ñ, Ñ) f32
    beta: torch.Tensor       # (D, Ñ, m) f32
    activation: str = "sigmoid"
    forget: float = 1.0

    def __post_init__(self) -> None:
        self.alpha, self.bias = _host_f32(self.alpha), _host_f32(self.bias)
        self.p, self.beta = _host_f32(self.p), _host_f32(self.beta)
        if self.p.ndim != 3 or self.beta.ndim != 3:
            raise ValueError(
                f"arena (P, β) must be (D, Ñ, ·): got {tuple(self.p.shape)}, "
                f"{tuple(self.beta.shape)}")
        if self.p.shape[0] != self.beta.shape[0]:
            raise ValueError(
                f"P and β disagree on D: {self.p.shape[0]} vs {self.beta.shape[0]}")
        if self.alpha.ndim != 2:
            raise ValueError(
                f"the arena keeps one shared basis α of shape (n, Ñ); got "
                f"{tuple(self.alpha.shape)}")

    @property
    def n_devices(self) -> int:
        return self.p.shape[0]

    @property
    def n_hidden(self) -> int:
        return self.p.shape[1]

    @property
    def n_out(self) -> int:
        return self.beta.shape[2]

    @property
    def n_features(self) -> int:
        return self.alpha.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.alpha, self.bias, self.p, self.beta))

    @classmethod
    def from_fleet(cls, states: OSELMState) -> "FleetArena":
        """Copy a stacked fleet into host memory. Its basis must be shared:
        a stacked (D, n, Ñ) basis whose devices differ raises, since Eq. 8
        merges only mean something over one basis."""
        alpha, bias = states.params.alpha, states.params.bias
        if alpha.ndim == 3:
            if not (bool((alpha == alpha[:1]).all()) and bool((bias == bias[:1]).all())):
                raise ValueError(
                    "stacked fleet does not share its SLFN basis — the arena stores "
                    "the basis once, and Eq. 8 merges are only meaningful over a "
                    "shared basis")
            alpha, bias = alpha[0], bias[0]
        return cls(alpha=_host_copy(alpha), bias=_host_copy(bias), p=_host_copy(states.p),
                   beta=_host_copy(states.beta), activation=states.activation,
                   forget=states.forget)

    def page(self, lo: int, hi: int) -> OSELMState:
        """The cohort's rows as an ``OSELMState`` over the one shared basis:
        views of the arena, no copy."""
        return OSELMState(params=SLFNParams(alpha=self.alpha, bias=self.bias),
                          beta=self.beta[lo:hi], p=self.p[lo:hi],
                          activation=self.activation, forget=self.forget)

    def write_page(self, lo: int, hi: int, p, beta, where=None) -> None:
        """Write a computed page back; ``where`` masks the rows written (the
        others keep their arena state)."""
        p, beta = torch.as_tensor(p), torch.as_tensor(beta)
        if where is None:
            self.p[lo:hi].copy_(p)
            self.beta[lo:hi].copy_(beta)
            return
        w = torch.as_tensor(np.asarray(where, bool))
        self.p[lo:hi][w] = p[w.to(p.device)].to("cpu", torch.float32)
        self.beta[lo:hi][w] = beta[w.to(beta.device)].to("cpu", torch.float32)

    def to_fleet(self, *, device: str | torch.device | None = None) -> OSELMState:
        """The whole fleet as the port's stacked state on ``device`` (the
        card unless ``device="cpu"``), a copy, with the one (n, Ñ) basis as
        the port keeps it. At arena scale this is the layout the arena
        exists to avoid: it is for evaluation and tests at small D."""
        device = resolve_device(device)

        def on(t: torch.Tensor) -> torch.Tensor:
            return t.to(device, copy=True)

        return OSELMState(params=SLFNParams(alpha=on(self.alpha), bias=on(self.bias)),
                          beta=on(self.beta), p=on(self.p),
                          activation=self.activation, forget=self.forget)

    def _pin(self) -> None:
        """Move (P, β) into pinned host memory (once), so that pages copy to
        and from the card asynchronously. Raises where pinning fails: a
        CUDA runtime never carries on with pageable memory."""
        for name in ("p", "beta"):
            t = getattr(self, name)
            if t.is_pinned():
                continue
            try:
                pinned = t.pin_memory()
            except RuntimeError as e:
                raise RuntimeError(
                    f"could not pin the arena's {name} ({t.numel() * 4} bytes) for "
                    "asynchronous page copies") from e
            if not pinned.is_pinned():
                raise RuntimeError(f"the arena's {name} did not come back pinned")
            setattr(self, name, pinned)


def _boot_chunk(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def init_arena(
    generator: torch.Generator,
    n_devices: int,
    n_features: int,
    n_hidden: int,
    x_init_fn,
    *,
    cohort_size: int,
    activation: str = "sigmoid",
    ridge: float = 0.0,
    forget: float = 1.0,
    device: str | torch.device | None = None,
) -> FleetArena:
    """Paged ``init_fleet``: one shared basis from ``generator``
    (``init_slfn``, as ``init_fleet`` draws it), then Eq. 13 a cohort at a
    time on ``device`` (the card unless ``device="cpu"``), each page
    written back to the host. ``x_init_fn(lo, hi)`` returns that cohort's
    boot chunks (hi − lo, n_init, n_features), so the full (D, n_init, n)
    array never exists."""
    device = resolve_device(device)
    if n_hidden >= n_features:
        raise ValueError(f"autoencoder needs a bottleneck: Ñ={n_hidden} >= n={n_features}")
    schedule = CohortSchedule(n_devices, cohort_size)
    params = init_slfn(generator, n_features, n_hidden, device=device)
    p = beta = None
    for lo, hi in schedule.bounds():
        x0 = _boot_chunk(x_init_fn(lo, hi), device)
        if x0.ndim != 3 or x0.shape[0] != hi - lo or x0.shape[2] != n_features:
            raise ValueError(
                f"boot chunk for [{lo}, {hi}) must be ({hi - lo}, n_init, {n_features}); "
                f"got {tuple(x0.shape)}")
        st = init_oselm(params, x0, x0, activation=activation, ridge=ridge, forget=forget)
        if p is None:
            p = torch.empty((n_devices,) + tuple(st.p.shape[1:]), dtype=torch.float32)
            beta = torch.empty((n_devices,) + tuple(st.beta.shape[1:]), dtype=torch.float32)
        p[lo:hi].copy_(st.p)
        beta[lo:hi].copy_(st.beta)
    return FleetArena(alpha=params.alpha.cpu(), bias=params.bias.cpu(), p=p, beta=beta,
                      activation=activation, forget=forget)


# --------------------------------------------------------------- schedule


@dataclasses.dataclass(frozen=True)
class CohortSchedule:
    """Which contiguous device block is on the card when.

    Equal cohorts (D divisible by ``cohort_size``) keep every page one
    shape. ``active_per_tick=None`` serves every cohort every tick; an
    integer round-robins that many cohorts a tick (the others keep their
    state; they still take part in merge rounds)."""

    n_devices: int
    cohort_size: int
    active_per_tick: int | None = None

    def __post_init__(self) -> None:
        if not 1 <= self.cohort_size <= self.n_devices:
            raise ValueError(
                f"need 1 <= cohort_size <= D: {self.cohort_size} vs D={self.n_devices}")
        if self.n_devices % self.cohort_size:
            raise ValueError(
                f"D={self.n_devices} not divisible by cohort_size={self.cohort_size}: "
                "every page must have one shape")
        if self.active_per_tick is not None and not (
            1 <= self.active_per_tick <= self.n_cohorts
        ):
            raise ValueError(
                f"active_per_tick={self.active_per_tick} outside [1, {self.n_cohorts}]")

    @property
    def n_cohorts(self) -> int:
        return self.n_devices // self.cohort_size

    def bounds(self, k: int | None = None):
        """(lo, hi) of cohort ``k``, or every cohort's bounds in order."""
        if k is not None:
            return k * self.cohort_size, (k + 1) * self.cohort_size
        return [(i * self.cohort_size, (i + 1) * self.cohort_size)
                for i in range(self.n_cohorts)]

    def active(self, tick: int) -> list[int]:
        """Cohorts served on ``tick`` (a round-robin window)."""
        n, a = self.n_cohorts, self.active_per_tick
        if a is None or a >= n:
            return list(range(n))
        start = (tick * a) % n
        return [(start + i) % n for i in range(a)]


# ----------------------------------------------------------- tier costs


@dataclasses.dataclass(frozen=True)
class TierCost:
    """One two-tier merge round's traffic by tier: tier 1 never leaves a
    cohort, tier 2 crosses the cohort heads' overlay (tree or halo) and
    must stay O(cohorts · clusters), never O(devices)."""

    topology: str
    n_devices: int
    n_cohorts: int
    tier1_payloads: int
    tier2_payloads: int
    payload_bytes: int

    @property
    def bytes_tier1(self) -> int:
        return self.tier1_payloads * self.payload_bytes

    @property
    def bytes_tier2(self) -> int:
        return self.tier2_payloads * self.payload_bytes

    @property
    def bytes_total(self) -> int:
        return self.bytes_tier1 + self.bytes_tier2


def cohort_round_cost(
    topology: Topology,
    schedule: CohortSchedule,
    n_hidden: int,
    n_out: int,
    *,
    itemsize: int = 4,
    precision: str = "f32",
) -> TierCost:
    """Payloads of one two-tier cooperative update, by tier (the
    reference's accounting):

    - isolated hierarchical clusters: members exchange with their head
      (tier 1 = 2(D − clusters)); a cluster spanning c > 1 cohorts ships
      c − 1 partial sums and downloads across the overlay (tier 2);
    - open ring: tier 2 is the 2·hops halo each cohort boundary exchanges,
      tier 1 the rest of the flat ring's traffic;
    - star, all-to-all, closed ring, hierarchical with head exchange:
      tier 1 = 2(D − cohorts), tier 2 = 2(cohorts − 1), a pairwise tree of
      cohort heads and its broadcast."""
    if topology.n_devices != schedule.n_devices:
        raise ValueError(f"topology D={topology.n_devices} vs schedule D={schedule.n_devices}")
    nb = payload_nbytes(n_hidden, n_out, itemsize,
                        precision=None if precision == "f32" else precision)
    d, nc = schedule.n_devices, schedule.n_cohorts
    if topology.kind == "segment" and not topology.head_exchange:
        cids = np.asarray(topology.cluster_ids)
        incidences = sum(len(np.unique(cids[lo:hi])) for lo, hi in schedule.bounds())
        tier1 = 2 * (d - topology.n_clusters)
        tier2 = 2 * (incidences - topology.n_clusters)
    elif topology.kind == "banded" and not topology.band_closed:
        tier2 = 2 * topology.hops * nc
        tier1 = max(topology.payloads_per_round - tier2, 0)
    elif topology.is_fully_connected or topology.kind == "segment":
        tier1 = 2 * (d - nc)
        tier2 = 2 * (nc - 1)
    else:
        raise NotImplementedError(
            f"no two-tier decomposition for topology {topology.name!r} "
            f"(kind={topology.kind!r})")
    return TierCost(topology=topology.name, n_devices=d, n_cohorts=nc,
                    tier1_payloads=int(tier1), tier2_payloads=int(tier2),
                    payload_bytes=int(nb))


# ---------------------------------------------------------------- paging


class _Staged:
    """A page's operands on their way to the card: ``take()`` makes the
    current stream wait for their copy and returns them."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors, event) -> None:
        self.tensors, self.event = tensors, event

    def take(self) -> list[torch.Tensor]:
        if self.event is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(self.event)
            for t in self.tensors:
                # allocated on the copy stream, read on this one: its memory
                # is not reused before this stream's work on it is done
                t.record_stream(stream)
        return self.tensors


class _Pager:
    """Moves arena pages between host and ``device``.

    On a CUDA device, ``fetch`` copies host tensors to the card on the
    ``h2d`` stream (pinned memory as it is; any other host operand through
    a pinned copy) and ``store`` copies computed pages back into the
    arena's pinned rows on the ``d2h`` stream once the current stream has
    produced them, each ordered by events and neither blocking the host;
    ``drain`` waits for both streams. Each copy and each compute step is
    timed by events (``times``). On the CPU the page operands are the
    arena's own views and a store is a copy."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.h2d = torch.cuda.Stream(device)
            self.d2h = torch.cuda.Stream(device)
        self._last_in = self._last_out = None
        self._spans: dict[str, list] = {"in": [], "out": [], "compute": []}
        self._host: dict[str, float] = {"in": 0.0, "out": 0.0, "compute": 0.0}
        self._t0 = time.perf_counter()

    def _event(self) -> torch.cuda.Event:
        return torch.cuda.Event(enable_timing=True)

    def fetch(self, *hosts) -> _Staged:
        t0 = time.perf_counter()
        tensors = [h if isinstance(h, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(h))
                   for h in hosts]
        if not self.cuda:
            self._host["in"] += time.perf_counter() - t0
            return _Staged(tensors, None)
        start, end = self._event(), self._event()
        out = []
        with torch.cuda.stream(self.h2d):
            start.record()
            for t in tensors:
                if t.device.type == "cuda":
                    out.append(t)
                    continue
                if not t.is_pinned():
                    t = t.pin_memory()
                out.append(t.to(self.device, non_blocking=True))
            end.record()
        self._spans["in"].append((start, end))
        self._last_in = end
        self._host["in"] += time.perf_counter() - t0
        return _Staged(out, end)

    def compute(self):
        """Times the page's compute on the current stream (a ``with``)."""
        return _Span(self)

    def store(self, *pairs) -> None:
        """Copy each (host destination, device source) pair back."""
        t0 = time.perf_counter()
        if not self.cuda:
            for dst, src in pairs:
                dst.copy_(src)
            self._host["out"] += time.perf_counter() - t0
            return
        ready = torch.cuda.Event()
        ready.record()
        self.d2h.wait_event(ready)
        start, end = self._event(), self._event()
        with torch.cuda.stream(self.d2h):
            start.record()
            for dst, src in pairs:
                dst.copy_(src, non_blocking=True)
                src.record_stream(self.d2h)
            end.record()
        self._spans["out"].append((start, end))
        self._last_out = end
        self._host["out"] += time.perf_counter() - t0

    def drain(self) -> None:
        """Wait until every copy issued so far has landed."""
        for ev in (self._last_in, self._last_out):
            if ev is not None:
                ev.synchronize()
        self._last_in = self._last_out = None

    def times(self) -> dict[str, float]:
        """Seconds since the last call (after ``drain``): on the card the
        copies' and the compute steps' device time by events (``in_s``,
        ``out_s``, ``compute_s``) and ``span_s`` from the first copy in to
        the last copy out; on the CPU the host time of each."""
        wall = time.perf_counter() - self._t0
        if self.cuda and self._spans["in"]:
            torch.cuda.current_stream().synchronize()
            sums = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3 for k, v in self._spans.items()}
            last = (self._spans["out"] or self._spans["compute"] or self._spans["in"])[-1][1]
            span = self._spans["in"][0][0].elapsed_time(last) / 1e3
        else:
            sums, span = dict(self._host), wall
        out = {"in_s": sums["in"], "out_s": sums["out"], "compute_s": sums["compute"],
               "span_s": span}
        self._spans = {k: [] for k in self._spans}
        self._host = dict.fromkeys(self._host, 0.0)
        self._t0 = time.perf_counter()
        return out

    def loop(self, bounds, inputs, compute) -> None:
        """The paged loop: page k+1's operands are copied in while page k
        computes, and page k's results are copied out as they are ready.
        ``inputs(lo, hi)`` gives a page's host operands; ``compute(lo, hi,
        *operands on the device)`` returns (host destination, device
        source) pairs to store, or nothing. Waits for every copy before it
        returns."""
        if not bounds:
            return
        nxt = self.fetch(*inputs(*bounds[0]))
        for i, (lo, hi) in enumerate(bounds):
            cur = nxt.take()
            with self.compute():
                stores = compute(lo, hi, *cur)
            if i + 1 < len(bounds):
                nxt = self.fetch(*inputs(*bounds[i + 1]))
            if stores:
                self.store(*stores)
        self.drain()


class _Span:
    __slots__ = ("pager", "start", "t0")

    def __init__(self, pager: _Pager) -> None:
        self.pager = pager

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        if self.pager.cuda:
            self.start = self.pager._event()
            self.start.record()
        return self

    def __exit__(self, *exc) -> bool:
        if self.pager.cuda:
            end = self.pager._event()
            end.record()
            self.pager._spans["compute"].append((self.start, end))
        else:
            self.pager._host["compute"] += time.perf_counter() - self.t0
        return False


# ------------------------------------------------------- two-tier merge


class CohortMerger:
    """Eq. 8 over a paged arena, one cohort page on ``device`` (the card
    unless ``device="cpu"``) at a time. The mode follows the topology:

    - ``global`` (star, all-to-all, closed ring, hierarchical with head
      exchange: one merged model for the fleet): tier 1 reduces each page
      to one masked partial (``masked_segment_sum_mix`` over one segment),
      tier 2 folds the (cohorts, Ñ, Ñ+m) stack (``cohort_tree_reduce``),
      one ``from_uv_solve`` serves every participant;
    - ``clusters`` (isolated hierarchical): tier 1 sums each page over its
      local cluster ids, tier 2 adds the page partials into the global
      (clusters, Ñ, Ñ+m) accumulator in page order (a cluster that
      straddles a cohort boundary takes a partial from both pages), one
      batched ``from_uv_solve``, and each page gathers its devices'
      cluster solutions back;
    - ``ring`` (open band): each page takes ``hops`` rows of halo from each
      neighbour, snapshotted before any page writes back, sums the band
      over the extended block (offsets descending, the reference's order)
      and solves per device with ``from_uv_solve``.

    The payload is the resident merge's: P⁻¹ by Cholesky (``invert_u``),
    symmetrised, then U·β. Devices outside the mask neither contribute
    nor receive: their arena rows are not touched.

    With a ``mesh`` (``repro_torch.launch.mesh.Mesh``) every rank holds the
    whole arena; in ``global`` mode each rank reduces its own contiguous
    block of cohorts, one all-reduce over ``mesh_axes`` completes tier 2,
    and every rank writes the merged model to every participant's rows.
    The ``clusters`` and ``ring`` modes do not use the mesh, as in the
    reference."""

    def __init__(
        self,
        topology: Topology,
        schedule: CohortSchedule,
        *,
        ridge: float = 0.0,
        mesh=None,
        mesh_axes=("data",),
        device: str | torch.device | None = None,
    ) -> None:
        if topology.n_devices != schedule.n_devices:
            raise ValueError(f"topology D={topology.n_devices} vs schedule D={schedule.n_devices}")
        self.topology = topology
        self.schedule = schedule
        self.ridge = float(ridge)
        self.mesh = mesh
        self.mesh_axes = tuple(mesh_axes)
        self.device = resolve_device(device)
        self._pager = _Pager(self.device)
        self._cids_dev = None

        if topology.kind == "segment" and not topology.head_exchange:
            self.mode = "clusters"
            cids = np.asarray(topology.cluster_ids, np.int64)
            if cids.shape[0] != topology.n_devices or np.any(np.diff(cids) < 0):
                raise ValueError(
                    "cluster_ids must be sorted/contiguous (as built by "
                    "fleet.topology.hierarchical): the paged segment sums take each "
                    "page's clusters as a contiguous id range")
            self._cids = cids
            # per cohort: its local ids (offset to 0) and the global offset;
            # k_max sums every page into one shape
            self._locals = []
            k_max = 1
            for lo, hi in schedule.bounds():
                sl = cids[lo:hi]
                off = int(sl[0])
                local = (sl - off).astype(np.int32)
                k_max = max(k_max, int(local[-1]) + 1)
                self._locals.append((off, local))
            self._k_max = k_max
        elif topology.kind == "banded" and not topology.band_closed:
            self.mode = "ring"
            if 2 * topology.hops >= topology.n_devices:
                raise ValueError("open band wider than the fleet")
        elif topology.is_fully_connected or topology.kind == "segment":
            self.mode = "global"
            if mesh is not None:
                mesh.block(schedule.n_cohorts, self.mesh_axes, "n_cohorts")
        else:
            raise NotImplementedError(
                f"two-tier merge needs a cluster-wise-constant topology or an open ring; "
                f"{topology.name!r} (kind={topology.kind!r}) mixes per-device neighbour "
                "sets that do not decompose over cohorts")

    def launches_per_round(self) -> dict[str, int]:
        """The kernels one round launches on the card: the segment sum once
        a page and one solve (``global``, ``clusters``), or one batched
        solve a page (``ring``)."""
        nc = self.schedule.n_cohorts
        if self.mode == "ring":
            return {"from_uv_solve": nc}
        return {"masked_segment_sum_mix": len(self._own_bounds()), "from_uv_solve": 1}

    def _own_bounds(self) -> list[tuple[int, int]]:
        """The cohorts whose tier-1 partials this rank computes: all of
        them, or in ``global`` mode over a mesh its contiguous block."""
        bounds = self.schedule.bounds()
        if self.mesh is None or self.mode != "global":
            return bounds
        lo, hi = self.mesh.block(len(bounds), self.mesh_axes, "n_cohorts")
        return bounds[lo:hi]

    def _w_of(self, p: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
        """The page's packed payloads [U | V], as ``fleet_to_uv`` forms them."""
        u = invert_u(p, ridge=self.ridge)
        u = 0.5 * (u + u.transpose(-1, -2))
        return torch.cat([u, u @ beta], dim=-1)

    def _solve(self, w: torch.Tensor, nh: int):
        return from_uv_solve(w[:, :, :nh], w[:, :, nh:], ridge=self.ridge)

    # ------------------------------------------------------------- merge

    def merge(self, arena: FleetArena, mask) -> TierCost:
        """One participation-masked two-tier cooperative update, in place on
        the arena; returns the round's cost by tier."""
        mask = np.asarray(mask, bool)
        if mask.shape != (arena.n_devices,):
            raise ValueError(f"mask shape {mask.shape} != (D={arena.n_devices},)")
        if arena.n_devices != self.schedule.n_devices:
            raise ValueError(f"arena D={arena.n_devices} vs schedule D={self.schedule.n_devices}")
        if self._pager.cuda:
            arena._pin()
        if self.mode == "ring":
            self._merge_ring(arena, mask)
        elif self.mode == "clusters":
            self._merge_clusters(arena, mask)
        else:
            self._merge_global(arena, mask)
        return cohort_round_cost(self.topology, self.schedule, arena.n_hidden, arena.n_out)

    def _pages_of(self, arena: FleetArena, mask: np.ndarray):
        return lambda lo, hi: (arena.p[lo:hi], arena.beta[lo:hi], mask[lo:hi])

    def _write_back(self, arena: FleetArena, mask: np.ndarray, merged) -> None:
        """Second pass: every page with a participant takes ``merged(lo,
        hi)`` = its merged (P, β) rows on its participants."""
        bounds = [(lo, hi) for lo, hi in self.schedule.bounds() if mask[lo:hi].any()]

        def write(lo, hi, p, b, m):
            pn, bn = merged(lo, hi)
            keep = m[:, None, None]
            return ((arena.p[lo:hi], torch.where(keep, pn, p)),
                    (arena.beta[lo:hi], torch.where(keep, bn, b)))

        self._pager.loop(bounds, self._pages_of(arena, mask), write)

    def _merge_global(self, arena: FleetArena, mask: np.ndarray) -> None:
        zeros = np.zeros(self.schedule.cohort_size, np.int32)
        parts = []

        def partial(lo, hi, p, b, m):
            w = self._w_of(p, b)
            parts.append(masked_segment_sum_mix(w, zeros, m.to(torch.float32), 1)[0])

        self._pager.loop(self._own_bounds(), self._pages_of(arena, mask), partial)
        if self.mesh is None:
            total = cohort_tree_reduce(torch.stack(parts))
        else:
            total = mesh_tree_reduce(torch.stack(parts), self.mesh, self.mesh_axes).to(self.device)
        p1, b1 = self._solve(total[None], arena.n_hidden)
        self._write_back(arena, mask, lambda lo, hi: (p1[0], b1[0]))

    def _cluster_ids_on(self) -> torch.Tensor:
        if self._cids_dev is None:
            self._cids_dev = torch.as_tensor(self._cids, device=self.device)
        return self._cids_dev

    def _merge_clusters(self, arena: FleetArena, mask: np.ndarray) -> None:
        nh, c = arena.n_hidden, self.schedule.cohort_size
        acc = torch.zeros((self.topology.n_clusters, nh, nh + arena.n_out),
                          dtype=torch.float32, device=self.device)

        def partial(lo, hi, p, b, m):
            off, local = self._locals[lo // c]
            part = masked_segment_sum_mix(self._w_of(p, b), local, m.to(torch.float32),
                                          self._k_max)
            k_here = int(local[-1]) + 1
            acc[off : off + k_here] += part[:k_here]

        self._pager.loop(self.schedule.bounds(), self._pages_of(arena, mask), partial)
        pc, bc = self._solve(acc, nh)
        cids = self._cluster_ids_on()
        self._write_back(arena, mask, lambda lo, hi: (pc[cids[lo:hi]], bc[cids[lo:hi]]))

    def _merge_ring(self, arena: FleetArena, mask: np.ndarray) -> None:
        d, hops, c = arena.n_devices, self.topology.hops, self.schedule.cohort_size
        nh = arena.n_hidden
        # each page's window sums read its neighbours' pre-merge payloads,
        # so the halos are copied out before any page writes back
        halos = []
        for lo, hi in self.schedule.bounds():
            ids = np.concatenate([np.arange(lo - hops, lo), np.arange(hi, hi + hops)]) % d
            rows = torch.from_numpy(ids)
            halos.append((arena.p[rows], arena.beta[rows], mask[ids].copy()))
        by_lo = {lo: h for (lo, _), h in zip(self.schedule.bounds(), halos)}

        def inputs(lo, hi):
            hp, hb, hm = by_lo[lo]
            return hp, arena.p[lo:hi], hb, arena.beta[lo:hi], hm, mask[lo:hi]

        def page(lo, hi, hp, p, hb, b, hm, m):
            # each device's payload on its own: the page's and the halo's
            # apart, so that the Cholesky inverses batch at the page's size
            wh = self._w_of(hp, hb)
            w = torch.cat([wh[:hops], self._w_of(p, b), wh[hops:]])
            m_ext = torch.cat([hm[:hops], m, hm[hops:]]).to(torch.float32)
            w = w * m_ext[:, None, None]
            # offsets descending, the order of the reference's paged ring
            mixed = w[2 * hops : 2 * hops + c]
            for o in range(2 * hops - 1, -1, -1):
                mixed = mixed + w[o : o + c]
            pc, bc = self._solve(mixed, nh)
            keep = m[:, None, None]
            return ((arena.p[lo:hi], torch.where(keep, pc, p)),
                    (arena.beta[lo:hi], torch.where(keep, bc, b)))

        self._pager.loop(self.schedule.bounds(), inputs, page)

    def warmup(self, arena: FleetArena) -> None:
        """Launch this mode's kernels once on a copy of the first page with
        an all-zero mask, and discard what they return: nothing of the
        arena changes."""
        lo, hi = self.schedule.bounds(0)
        p = arena.p[lo:hi].to(self.device)
        b = arena.beta[lo:hi].to(self.device)
        w = self._w_of(p, b)
        zero = torch.zeros(hi - lo, dtype=torch.float32, device=self.device)
        if self.mode == "ring":
            self._solve(w, arena.n_hidden)
            return
        ids, k = ((np.zeros(hi - lo, np.int32), 1) if self.mode == "global"
                  else (self._locals[0][1], self._k_max))
        self._solve(masked_segment_sum_mix(w, ids, zero, k), arena.n_hidden)
