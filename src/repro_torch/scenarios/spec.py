"""Paper-fidelity scenario layer — workloads as streaming fleet feeds;
port of ``repro.scenarios.spec`` (the clean presets: fault schedules
wait for the port of ``fleet/faults.py``).

The paper's whole evaluation (§5) is three streaming anomaly-detection
workloads — a car-driving dataset, a human-activity dataset, and MNIST
— each run as a fleet of non-IID edge devices that train online, merge
cooperatively, and are scored on held-out anomalous concepts. The repo
has every *mechanism* (topology merges, fused ingest kernels, the
resident runtime with drift gating); ``ScenarioSpec`` is the layer that
turns a workload into something those mechanisms can run end-to-end:

- **per-device pattern assignment** — which normal concept(s) each
  device observes (round-robin "Device-A/B/C" homes, or Dirichlet user
  skew), restricted to the spec's ``normal_classes``;
- **normal/anomalous phases** — every device starts in its home
  (normal) phase; a ``drift_frac`` fraction switches mid-stream to a
  drift target drawn from the held-out anomaly pool, so the drifted
  concept is exactly what the eval protocol labels anomalous
  (``FleetStreams.phase_boundaries`` exposes the phase starts);
- **held-out anomaly pools** — ``anomaly_classes`` are carved out of
  the dataset (``class_subset`` remaps them after the homes), never
  appear in any training stream before a drift event, and form the
  positive class of the §5.3.1 eval arrays;
- **a tick feed** — the built scenario wraps its streams in the
  runtime's ``TickFeed`` so one spec drives ``FleetRuntime`` unchanged
  on every topology.

Three paper-analog presets are registered (``make_scenario``):
``driving`` (multi-regime correlated sensor channels — normal + drowsy
regimes home, the high-entropy aggressive regime held out), ``har``
(segmented activity windows with per-device Dirichlet user skew —
sitting/standing home, laying held out), and ``mnist_like``
(high-dimensional digit-pattern analog — digits 0–7 home, 8/9 held
out). The evaluation harness on top lives in
``repro_torch.scenarios.evaluate``. ``build`` is numpy only and gives the
reference's arrays bit for bit; the fleet is made with a
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import numpy as np

from repro_torch.data.pipeline import (
    anomaly_eval_arrays,
    class_subset,
    normalize_minmax,
    train_test_split,
)
from repro_torch.data.synthetic import DATASETS, AnomalyDataset, make_dataset
from repro_torch.fleet.partition import (
    DriftEvent,
    FleetStreams,
    make_fleet_streams,
    random_drift_schedule,
)
from repro_torch.runtime.detector import DetectorConfig

__all__ = [
    "SCENARIOS",
    "Scenario",
    "ScenarioSpec",
    "make_scenario",
]


@functools.lru_cache(maxsize=8)
def _raw_dataset(name: str, seed: int, samples_per_class: int) -> AnomalyDataset:
    """Synthesizing a dataset is the expensive part of a build (the
    driving analog runs a Markov simulator per sample); every consumer
    of the same (name, seed, size) shares one copy. Treated as
    immutable by the whole pipeline."""
    return make_dataset(name, seed=seed, samples_per_class=samples_per_class)


class Scenario(NamedTuple):
    """A built scenario: everything needed to drive a fleet end-to-end."""

    spec: "ScenarioSpec"
    train: AnomalyDataset     # remapped (homes 0.., anomalies after) + normalized
    test: AnomalyDataset
    streams: FleetStreams     # per-device non-IID streams + drift schedule
    x_eval: np.ndarray        # §5.3.1 eval arrays: trained patterns normal,
    y_eval: np.ndarray        # held-out anomaly pool positive

    @property
    def n_features(self) -> int:
        return self.train.n_features

    def feed(self, batch: int | None = None):
        """The runtime's tick view of the streams (fresh cursorless view
        per call; the default batch is the spec's)."""
        from repro_torch.runtime.feed import TickFeed

        return TickFeed(self.streams, self.spec.batch if batch is None else batch)

    def init_fleet(self, generator, **overrides):
        """The spec's stacked fleet (shared SLFN basis drawn from the
        ``torch.Generator``, per-device Eq. 13 init chunks) — ``overrides``
        (``device`` among them) forward to ``init_fleet``."""
        from repro_torch.fleet.fleet import init_fleet

        kw = dict(
            activation=self.spec.activation,
            ridge=self.spec.ridge,
            forget=self.spec.forget,
        )
        kw.update(overrides)
        return init_fleet(
            generator, self.spec.n_devices, self.n_features, self.spec.n_hidden,
            self.streams.x_init, **kw,
        )


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One workload as a streaming non-IID fleet feed.

    Class ids refer to the UNDERLYING dataset (``repro_torch.data.synthetic``
    names/order); ``build`` remaps them so homes occupy 0..n_normal−1
    and the anomaly pool follows — downstream code never sees the
    original ids.
    """

    name: str
    dataset: str                              # repro_torch.data.synthetic generator
    n_devices: int
    ticks: int
    batch: int = 2                            # samples per device per tick
    n_hidden: int = 16
    n_init: int | None = None                 # Eq. 13 chunk; default 2·n_hidden
    normal_classes: tuple[int, ...] = (0, 1)  # per-device home patterns
    anomaly_classes: tuple[int, ...] = (2,)   # held-out anomaly pool
    assignment: str = "round_robin"           # or "dirichlet" (user skew)
    alpha: float = 0.5                        # Dirichlet concentration
    drift_frac: float = 0.25                  # fraction of devices that drift
    drift_targets: tuple[int, ...] | None = None  # default: whole anomaly pool
    activation: str = "identity"
    ridge: float = 1e-3
    forget: float = 1.0                       # λ
    # scenario detector convention: skip the fresh fleet's convergence
    # transient, calibrate across the first cooperative merge (warmup 20
    # spans the merge-every-16 default, so the post-merge loss regime is
    # inside every device's band), and floor sigma at a fraction of the
    # baseline mean (near-pure-pattern devices calibrate microscopic
    # bands otherwise). Drift injection starts at tick ticks//4 — keep
    # warmup at or below that or early drifts are absorbed as baseline.
    detector: DetectorConfig = dataclasses.field(
        default_factory=lambda: DetectorConfig(
            warmup=20, warmup_skip=6, rel_sigma=0.25
        )
    )
    samples_per_class: int = 150
    anomaly_ratio: float = 0.3                # eval positives / negatives
    train_frac: float = 0.8                   # §5.3.1 split
    seed: int = 0
    # fault schedules (Byzantine payloads, crashes, poisoned streams) wait
    # for the port of fleet/faults.py; a spec that carries any raises
    faults: tuple = ()

    def __post_init__(self) -> None:
        if self.dataset not in DATASETS:
            raise ValueError(
                f"unknown dataset {self.dataset!r}; have {sorted(DATASETS)}"
            )
        for field, lo in (("n_devices", 1), ("ticks", 1), ("batch", 1),
                          ("n_hidden", 1), ("samples_per_class", 8)):
            if getattr(self, field) < lo:
                raise ValueError(f"need {field} >= {lo}, got {getattr(self, field)}")
        if not self.normal_classes:
            raise ValueError("need at least one normal (home) class")
        if not self.anomaly_classes:
            raise ValueError("need a non-empty held-out anomaly pool")
        for label, classes in (("normal", self.normal_classes),
                               ("anomaly", self.anomaly_classes)):
            if len(set(classes)) != len(classes):
                raise ValueError(f"duplicate {label} classes: {classes!r}")
        overlap = set(self.normal_classes) & set(self.anomaly_classes)
        if overlap:
            raise ValueError(
                f"anomaly pool must be held out of the training streams; "
                f"classes {sorted(overlap)} are in both"
            )
        if not 0.0 <= self.drift_frac <= 1.0:
            raise ValueError(f"need 0 <= drift_frac <= 1, got {self.drift_frac}")
        targets = self.drift_targets
        if targets is not None and not set(targets) <= set(self.anomaly_classes):
            raise ValueError(
                "drift targets must come from the held-out anomaly pool "
                f"(targets={targets!r}, pool={self.anomaly_classes!r}) — a "
                "drift into a home class would blur the normal/anomalous "
                "phase boundary the eval protocol scores against"
            )
        if self.assignment not in ("round_robin", "dirichlet"):
            raise ValueError(f"unknown assignment {self.assignment!r}")
        if not 0.0 < self.train_frac < 1.0:
            raise ValueError(f"need 0 < train_frac < 1, got {self.train_frac}")
        if not 0.0 < self.forget <= 1.0:
            raise ValueError(f"need 0 < forget <= 1, got {self.forget}")
        if self.faults:
            raise NotImplementedError(
                "fault schedules need fleet/faults.py, which the port does not have yet"
            )

    # ------------------------------------------------------------ derived

    @property
    def n_normal(self) -> int:
        return len(self.normal_classes)

    @property
    def steps(self) -> int:
        """Stream length: every tick ingests ``batch`` samples/device."""
        return self.ticks * self.batch

    @property
    def init_chunk(self) -> int:
        return 2 * self.n_hidden if self.n_init is None else self.n_init

    def remapped_anomaly_classes(self) -> tuple[int, ...]:
        """The anomaly pool's ids AFTER the build's class remap (homes
        first): n_normal, n_normal+1, ..."""
        return tuple(range(self.n_normal, self.n_normal + len(self.anomaly_classes)))

    def drift_schedule(self) -> tuple[DriftEvent, ...]:
        """The spec's reproducible drift injection: ``drift_frac`` of the
        fleet switches mid-stream to a held-out target (remapped ids)."""
        if self.drift_frac == 0.0:
            return ()
        targets = self.drift_targets or self.anomaly_classes
        remap = {c: self.n_normal + i for i, c in enumerate(self.anomaly_classes)}
        return random_drift_schedule(
            self.n_devices,
            self.steps,
            self.n_normal + len(self.anomaly_classes),
            frac=self.drift_frac,
            seed=self.seed + 1,
            home_classes=self.n_normal,
            targets=tuple(remap[t] for t in targets),
        )

    # -------------------------------------------------------------- build

    def build(self) -> Scenario:
        """Synthesize the workload into a runnable scenario: dataset →
        remap/normalize/split → non-IID streams with drift → eval
        arrays. Deterministic in the spec (same spec, same bits)."""
        ds = _raw_dataset(self.dataset, self.seed, self.samples_per_class)
        ds = class_subset(ds, self.normal_classes + self.anomaly_classes)
        ds = normalize_minmax(ds)
        train, test = train_test_split(ds, self.train_frac, seed=self.seed)
        streams = make_fleet_streams(
            train,
            self.n_devices,
            self.steps,
            n_init=self.init_chunk,
            assignment=self.assignment,
            alpha=self.alpha,
            drift=self.drift_schedule(),
            seed=self.seed,
            n_assign=self.n_normal,
        )
        x_eval, y_eval = anomaly_eval_arrays(
            test,
            list(range(self.n_normal)),
            anomaly_ratio=self.anomaly_ratio,
            seed=self.seed,
        )
        return Scenario(
            spec=self, train=train, test=test, streams=streams,
            x_eval=x_eval, y_eval=y_eval,
        )


# ------------------------------------------------------- paper-analog presets


def _driving_spec() -> ScenarioSpec:
    """UAH-DriveSet analog: 15×15 speed-transition tables from three
    correlated Markov driving regimes. Devices home on the normal and
    drowsy regimes; the high-entropy aggressive regime (volatile Markov
    dynamics → diffuse transition tables an AE trained on calm regimes
    cannot reconstruct) is held out, and a quarter of the fleet drifts
    into it mid-stream — exactly the concept the detector must flag."""
    return ScenarioSpec(
        name="driving", dataset="driving",
        n_devices=12, ticks=80,
        normal_classes=(0, 2),      # normal, drowsy
        anomaly_classes=(1,),       # aggressive — held out
        n_hidden=16, samples_per_class=160,
    )


def _har_spec() -> ScenarioSpec:
    """Smartphone-HAR analog: segmented activity windows with per-device
    user skew — each device draws its own Dirichlet mixture over the
    sitting / standing manifolds (the paper notes their similarity; no
    two users split alike), and the laying pattern (far from everything,
    Fig. 7/9) is the held-out anomaly concept."""
    return ScenarioSpec(
        name="har", dataset="har",
        n_devices=12, ticks=80,
        normal_classes=(3, 4),      # sitting, standing
        anomaly_classes=(5,),       # laying — held out
        assignment="dirichlet", alpha=0.5,
        n_hidden=16, samples_per_class=150,
    )


def _mnist_spec() -> ScenarioSpec:
    """MNIST analog: 784-dim digit-pattern streams from the smooth
    per-class prototypes. Digits 0–7 are the per-device home patterns
    (round-robin, the paper's Device-A/B/C setting scaled up); digits
    8/9 are the held-out anomaly pool. The drifted-digit loss elevation
    is brief (the k=1 RLS chain learns the new prototype within a few
    ticks), so the preset detector runs a faster EWMA and a tighter
    threshold than the scenario default."""
    return ScenarioSpec(
        name="mnist_like", dataset="mnist_like",
        n_devices=16, ticks=80,
        normal_classes=tuple(range(8)),
        anomaly_classes=(8, 9),
        n_hidden=32, samples_per_class=120,
        detector=DetectorConfig(
            warmup=20, warmup_skip=6, rel_sigma=0.25, alpha=0.6, k_sigma=3.5
        ),
    )


def _adversarial_spec() -> ScenarioSpec:
    """The HAR workload with 10% of devices mounting a payload scale
    attack, in the reference. Its fault schedule needs fleet/faults.py,
    which the port does not have yet."""
    raise NotImplementedError(
        "the adversarial preset needs fleet/faults.py, which the port does not have yet"
    )


SCENARIOS: dict[str, Callable[[], ScenarioSpec]] = {
    "driving": _driving_spec,
    "har": _har_spec,
    "mnist_like": _mnist_spec,
    "adversarial": _adversarial_spec,
}


def make_scenario(name: str, **overrides) -> ScenarioSpec:
    """A registered paper-analog spec, optionally resized/retuned —
    ``make_scenario("har", n_devices=6, ticks=40)`` is how the smoke
    harness shrinks the workloads without touching their structure."""
    try:
        base = SCENARIOS[name]()
    except KeyError as e:
        raise ValueError(f"unknown scenario {name!r}; have {sorted(SCENARIOS)}") from e
    return dataclasses.replace(base, **overrides) if overrides else base
