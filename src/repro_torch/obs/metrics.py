"""Typed host-side metrics: counters, gauges, histograms, phase timers;
port of ``repro.obs.metrics``.

The fleet runtime's observable signals — per-tick phase wall-clock,
merge-round bytes by wire precision, quarantine populations, detector
band dynamics — go through ``MetricsRegistry``: plain Python objects
updated on the host between kernel launches, never on the device.

Conventions (Prometheus-flavored, but deliberately tiny):

- **Counter** — monotone accumulator (``inc`` rejects negative deltas);
  restore-continuity across snapshot round-trips is what the
  monotonicity tests lock.
- **Gauge** — last-write-wins level (quarantine population, EF-residual
  norm).
- **Histogram** — fixed upper-bound bucket edges (``le`` semantics,
  +Inf implicit) plus a bounded window of raw samples so quantiles
  (``quantile(0.99)``) are exact over the retained window instead of
  bucket-interpolated.
- **Labels** — a metric declared with ``labels=("phase",)`` is a family;
  ``family.labels(phase="merge")`` lazily materializes one child per
  label value. Children are ordinary metrics.

``phase_timer`` wraps one tick phase in a wall-clock measurement with
an explicit *fence*: the caller hands the phase's outputs to
``handle.fence(...)`` and the timer synchronizes every CUDA device those
tensors live on before reading the clock (``torch.cuda.synchronize``;
nothing for CPU tensors), so PyTorch's asynchronous launches cannot bill
a phase's device work to whichever later phase happens to synchronize
first.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import math
import time
from collections import deque
from typing import Callable, Iterable

import numpy as np
import torch

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "fence",
    "phase_timer",
]

# wall-clock seconds buckets spanning 10 µs .. 10 s (tick phases land
# mid-range; a first tick that builds the kernels in the top buckets)
LATENCY_BUCKETS_S = (
    1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0, 10.0,
)


class Counter:
    """Monotone accumulator."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters are monotone: inc({n}) rejected")
        self.value += n


class Gauge:
    """Last-write-wins level."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with a bounded raw-sample window.

    ``buckets`` are inclusive upper bounds (Prometheus ``le``); an
    implicit +Inf bucket catches the tail. ``quantile`` is computed
    over the retained raw samples (the most recent ``sample_cap``
    observations) — exact for runs shorter than the cap, a sliding
    window beyond it.
    """

    __slots__ = (
        "buckets", "_edges", "counts", "count", "sum", "vmin", "vmax", "samples",
    )

    def __init__(
        self,
        buckets: Iterable[float] = LATENCY_BUCKETS_S,
        *,
        sample_cap: int = 4096,
    ) -> None:
        edges = tuple(float(b) for b in buckets)
        if not edges or any(nxt <= prev for nxt, prev in zip(edges[1:], edges)):
            raise ValueError(f"bucket edges must strictly increase: {edges}")
        self.buckets = edges
        self._edges = np.asarray(edges)        # for vectorized searchsorted
        self.counts = [0] * (len(edges) + 1)   # last = +Inf overflow
        self.count = 0
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.samples: deque[float] = deque(maxlen=sample_cap)

    def observe(self, v: float) -> None:
        v = float(v)
        # bisect on the edge tuple: ~20x cheaper per call than a numpy
        # searchsorted (which re-wraps the scalar) — observe() runs
        # several times per serving tick
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        self.samples.append(v)

    def observe_many(self, values: np.ndarray) -> None:
        values = np.asarray(values, np.float64).ravel()
        if values.size == 0:
            return
        idx = np.searchsorted(self._edges, values, side="left")
        for i, n in enumerate(np.bincount(idx, minlength=len(self.counts))):
            if n:
                self.counts[i] += int(n)
        self.count += int(values.size)
        self.sum += float(values.sum())
        self.vmin = min(self.vmin, float(values.min()))
        self.vmax = max(self.vmax, float(values.max()))
        self.samples.extend(values.tolist())

    def quantile(self, q: float) -> float | None:
        """q-quantile over the retained sample window; None when empty."""
        if not self.samples:
            return None
        return float(np.percentile(np.fromiter(self.samples, np.float64), 100 * q))

    def snapshot(self) -> dict:
        return {
            "buckets": list(self.buckets),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.sum,
            "min": None if self.count == 0 else self.vmin,
            "max": None if self.count == 0 else self.vmax,
            "samples": list(self.samples),
        }

    def load(self, state: dict) -> None:
        if tuple(state["buckets"]) != self.buckets:
            raise ValueError(
                f"histogram bucket mismatch: snapshot {state['buckets']} vs "
                f"declared {list(self.buckets)}"
            )
        self.counts = [int(c) for c in state["counts"]]
        self.count = int(state["count"])
        self.sum = float(state["sum"])
        self.vmin = math.inf if state["min"] is None else float(state["min"])
        self.vmax = -math.inf if state["max"] is None else float(state["max"])
        self.samples.clear()
        self.samples.extend(float(s) for s in state["samples"])


class _Family:
    """Lazily-materialized labeled children of one declared metric."""

    __slots__ = ("name", "label_names", "_ctor", "children")

    def __init__(self, name: str, label_names: tuple[str, ...], ctor: Callable):
        self.name = name
        self.label_names = label_names
        self._ctor = ctor
        self.children: dict[tuple[str, ...], Counter | Gauge | Histogram] = {}

    def labels(self, **labels: str):
        if tuple(sorted(labels)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(labels))}"
            )
        key = tuple(str(labels[k]) for k in self.label_names)
        child = self.children.get(key)
        if child is None:
            child = self.children[key] = self._ctor()
        return child


def _valid_name(name: str) -> str:
    if not name or not all(c.isalnum() or c == "_" for c in name):
        raise ValueError(f"metric names are [A-Za-z0-9_]+, got {name!r}")
    return name


class MetricsRegistry:
    """Declaration-ordered registry of named metrics.

    Declaring the same name twice returns the SAME object (so a sink
    and a benchmark can both ask for ``merge_rounds_total`` without
    coordinating), but re-declaring with a different type or label set
    is an error — one name, one meaning.
    """

    def __init__(self) -> None:
        self._metrics: dict[str, tuple[str, tuple[str, ...], object, str]] = {}

    def _declare(self, kind: str, name: str, help: str,
                 labels: tuple[str, ...], ctor: Callable):
        _valid_name(name)
        labels = tuple(labels)
        existing = self._metrics.get(name)
        if existing is not None:
            ekind, elabels, obj, _ = existing
            if ekind != kind or elabels != labels:
                raise ValueError(
                    f"metric {name!r} already declared as {ekind}{elabels}, "
                    f"cannot re-declare as {kind}{labels}"
                )
            return obj
        obj = _Family(name, labels, ctor) if labels else ctor()
        self._metrics[name] = (kind, labels, obj, help)
        return obj

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = ()) -> Counter | _Family:
        return self._declare("counter", name, help, labels, Counter)

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = ()) -> Gauge | _Family:
        return self._declare("gauge", name, help, labels, Gauge)

    def histogram(
        self, name: str, help: str = "", labels: tuple[str, ...] = (),
        *, buckets: Iterable[float] = LATENCY_BUCKETS_S, sample_cap: int = 4096,
    ) -> Histogram | _Family:
        return self._declare(
            "histogram", name, help, labels,
            lambda: Histogram(buckets, sample_cap=sample_cap),
        )

    # ------------------------------------------------------------ iteration

    def _children(self, name: str):
        """Yield (label_dict, metric) pairs of one declared name."""
        kind, labels, obj, _ = self._metrics[name]
        if not labels:
            yield {}, obj
            return
        for key, child in sorted(obj.children.items()):
            yield dict(zip(labels, key)), child

    # ------------------------------------------------------------ exposition

    def exposition(self) -> str:
        """Prometheus-style text exposition of every declared metric."""
        out = []
        for name, (kind, _labels, _obj, help) in self._metrics.items():
            if help:
                out.append(f"# HELP {name} {help}")
            out.append(f"# TYPE {name} {kind}")
            for lbl, m in self._children(name):
                tag = (
                    "{" + ",".join(f'{k}="{v}"' for k, v in lbl.items()) + "}"
                    if lbl else ""
                )
                if kind in ("counter", "gauge"):
                    out.append(f"{name}{tag} {_fmt(m.value)}")
                else:
                    cum = 0
                    for edge, c in zip(m.buckets, m.counts):
                        cum += c
                        le = dict(lbl, le=_fmt(edge))
                        ltag = "{" + ",".join(
                            f'{k}="{v}"' for k, v in le.items()) + "}"
                        out.append(f"{name}_bucket{ltag} {cum}")
                    inf = "{" + ",".join(
                        f'{k}="{v}"' for k, v in dict(lbl, le="+Inf").items()
                    ) + "}"
                    out.append(f"{name}_bucket{inf} {m.count}")
                    out.append(f"{name}_sum{tag} {_fmt(m.sum)}")
                    out.append(f"{name}_count{tag} {m.count}")
        return "\n".join(out) + "\n"

    # ------------------------------------------------------- summary / state

    def summary(self) -> dict:
        """Flat JSON-able view: one entry per (metric, label) child."""
        out: dict[str, dict] = {}
        for name, (kind, _labels, _obj, _help) in self._metrics.items():
            rows = []
            for lbl, m in self._children(name):
                if kind in ("counter", "gauge"):
                    rows.append({"labels": lbl, "value": m.value})
                else:
                    rows.append({
                        "labels": lbl,
                        "count": m.count,
                        "sum": m.sum,
                        "mean": m.sum / m.count if m.count else None,
                        "min": None if m.count == 0 else m.vmin,
                        "max": None if m.count == 0 else m.vmax,
                        "p50": m.quantile(0.50),
                        "p99": m.quantile(0.99),
                    })
            out[name] = {"type": kind, "series": rows}
        return out

    def state(self) -> dict:
        """Full restorable state (JSON-able) — what snapshots persist."""
        out = []
        for name, (kind, _labels, _obj, _help) in self._metrics.items():
            for lbl, m in self._children(name):
                row = {"name": name, "kind": kind, "labels": lbl}
                if kind in ("counter", "gauge"):
                    row["value"] = m.value
                else:
                    row["histogram"] = m.snapshot()
                out.append(row)
        return {"metrics": out}

    def load_state(self, state: dict) -> None:
        """Restore a ``state()`` snapshot into the declared metrics.

        Snapshot entries whose name is not declared here are ignored
        (a telemetry schema can grow without stranding old snapshots);
        declared metrics missing from the snapshot keep their current
        values."""
        for row in state.get("metrics", ()):
            declared = self._metrics.get(row["name"])
            if declared is None:
                continue
            kind, labels, obj, _ = declared
            if kind != row["kind"]:
                raise ValueError(
                    f"{row['name']}: snapshot kind {row['kind']} vs "
                    f"declared {kind}"
                )
            m = obj.labels(**row["labels"]) if labels else obj
            if kind in ("counter", "gauge"):
                m.value = float(row["value"])
            else:
                m.load(row["histogram"])

    def roundtrip_check(self) -> None:  # pragma: no cover - debugging aid
        json.dumps(self.state())


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _PhaseHandle:
    """Mutable holder the timed block parks its outputs in."""

    __slots__ = ("_tree",)

    def __init__(self) -> None:
        self._tree = None

    def fence(self, tree) -> None:
        self._tree = tree


def _cuda_devices(tree, found: set) -> set:
    """The CUDA devices of the tensors in ``tree`` (tensors, sequences,
    dicts and dataclasses of them)."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), found)
    return found


def fence(tree) -> None:
    """Wait for the work on every CUDA device that holds a tensor of
    ``tree``; CPU tensors need nothing."""
    for device in _cuda_devices(tree, set()):
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase_timer(observe: Callable[[float], None]):
    """Time one phase, fencing whatever the block handed to
    ``handle.fence(...)`` before the clock is read — PyTorch's
    asynchronous launches otherwise bill a phase's device work to the
    next caller of ``torch.cuda.synchronize``. ``observe`` receives the
    fenced seconds."""
    handle = _PhaseHandle()
    t0 = time.perf_counter()
    try:
        yield handle
    finally:
        if handle._tree is not None:
            fence(handle._tree)
        observe(time.perf_counter() - t0)
