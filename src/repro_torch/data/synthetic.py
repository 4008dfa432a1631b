"""Synthetic analogues of the paper's three datasets (Table 2); numpy
copy of ``repro.data.synthetic``, bit-identical from the same seed.

| paper dataset      | features | classes | analogue here                      |
|--------------------|----------|---------|------------------------------------|
| UAH-DriveSet [21]  | 225      | 3       | Markov speed-trace simulator →     |
|                    |          |         | 15×15 state-transition prob table  |
| Smartphone HAR [22]| 561      | 6       | per-activity low-rank Gaussian     |
|                    |          |         | manifolds (sitting≈standing,       |
|                    |          |         | walking* mutually close)           |
| MNIST [23]         | 784      | 10      | smooth per-class prototypes with   |
|                    |          |         | elastic deformations, in [0,1]     |

The real datasets are unavailable offline; feature
dimensionality, class structure and the semi-supervised protocol match
the paper exactly, so the paper's *relative* claims (loss collapse after
merge, post-merge ROC-AUC parity with BP-NN, latency ratios) remain
testable.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np


class AnomalyDataset(NamedTuple):
    name: str
    x: np.ndarray          # (samples, features) float32
    y: np.ndarray          # (samples,) int class labels
    class_names: tuple[str, ...]

    @property
    def n_features(self) -> int:
        return int(self.x.shape[1])

    @property
    def n_classes(self) -> int:
        return len(self.class_names)

    def pattern(self, cls: int | str) -> np.ndarray:
        if isinstance(cls, str):
            cls = self.class_names.index(cls)
        return self.x[self.y == cls]


# ----------------------------------------------------------- driving

_DRIVE_CLASSES = ("normal", "aggressive", "drowsy")

# Markov speed dynamics per driving pattern over 15 speed levels
# (1 level = 10 km/h, as in the paper). (drift, volatility, mean level)
_DRIVE_DYNAMICS = {
    "normal": (0.30, 0.8, 7.0),
    "aggressive": (0.85, 2.6, 11.0),
    "drowsy": (0.12, 0.5, 5.0),
}


def _simulate_speed_trace(rng: np.random.Generator, pattern: str, steps: int) -> np.ndarray:
    """1 Hz speed trace, quantized to 15 levels, as an OU-like process
    whose pull/volatility depend on the driving pattern."""
    pull, vol, mean = _DRIVE_DYNAMICS[pattern]
    v = mean + rng.normal() * 2.0
    levels = np.empty(steps, dtype=np.int32)
    for i in range(steps):
        # aggressive drivers make large jerky corrections; drowsy drift
        v = v + pull * (mean - v) * 0.15 + rng.normal() * vol
        if pattern == "aggressive" and rng.random() < 0.15:
            v += rng.choice((-4.0, 4.0))  # hard brake / hard accel
        v = float(np.clip(v, 0.0, 14.0))
        levels[i] = int(round(v))
    return levels


def _transition_table(levels: np.ndarray, n_states: int = 15) -> np.ndarray:
    """The paper's feature: 15×15 state-transition probability table."""
    counts = np.zeros((n_states, n_states), dtype=np.float64)
    np.add.at(counts, (levels[:-1], levels[1:]), 1.0)
    row = counts.sum(axis=1, keepdims=True)
    probs = np.divide(counts, row, out=np.zeros_like(counts), where=row > 0)
    return probs.reshape(-1).astype(np.float32)


def make_driving_dataset(
    seed: int = 0, samples_per_class: int = 400, window: int = 240
) -> AnomalyDataset:
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for ci, cls in enumerate(_DRIVE_CLASSES):
        for _ in range(samples_per_class):
            trace = _simulate_speed_trace(rng, cls, window)
            xs.append(_transition_table(trace))
            ys.append(ci)
    return AnomalyDataset(
        name="driving",
        x=np.stack(xs),
        y=np.asarray(ys, dtype=np.int32),
        class_names=_DRIVE_CLASSES,
    )


# ---------------------------------------------------------------- HAR

_HAR_CLASSES = (
    "walking", "walking_upstairs", "walking_downstairs",
    "sitting", "standing", "laying",
)


def make_har_dataset(
    seed: int = 0, samples_per_class: int = 500, n_features: int = 561
) -> AnomalyDataset:
    """Low-rank Gaussian manifold per activity.

    Class geometry mirrors the paper's observations (Fig. 7/9):
    the three walking variants share a common 'dynamic' subspace and are
    mutually close; sitting and standing are similar to each other
    ('there is a similarity between the sitting pattern and standing
    pattern'); laying is far from everything.
    """
    rng = np.random.default_rng(seed)
    rank = 12

    base_dynamic = rng.normal(size=n_features) * 0.8        # shared by walking*
    base_static = rng.normal(size=n_features) * 0.8         # shared by sit/stand
    dyn_factors = rng.normal(size=(rank, n_features)) / np.sqrt(rank)
    stat_factors = rng.normal(size=(rank, n_features)) / np.sqrt(rank)

    means = {
        "walking": base_dynamic + 0.35 * rng.normal(size=n_features),
        "walking_upstairs": base_dynamic + 0.45 * rng.normal(size=n_features),
        "walking_downstairs": base_dynamic + 0.60 * rng.normal(size=n_features),
        "sitting": base_static + 0.25 * rng.normal(size=n_features),
        "standing": base_static + 0.30 * rng.normal(size=n_features),
        "laying": rng.normal(size=n_features) * 1.6,
    }
    factors = {
        c: (dyn_factors if c.startswith("walking") else stat_factors)
        + 0.3 * rng.normal(size=(rank, n_features)) / np.sqrt(rank)
        for c in _HAR_CLASSES
    }

    xs, ys = [], []
    for ci, cls in enumerate(_HAR_CLASSES):
        latent = rng.normal(size=(samples_per_class, rank))
        noise = rng.normal(size=(samples_per_class, n_features)) * 0.08
        xs.append((means[cls] + latent @ factors[cls] + noise).astype(np.float32))
        ys.append(np.full(samples_per_class, ci, dtype=np.int32))
    return AnomalyDataset(
        name="har", x=np.concatenate(xs), y=np.concatenate(ys), class_names=_HAR_CLASSES
    )


# -------------------------------------------------------- MNIST-like

_MNIST_CLASSES = tuple(str(d) for d in range(10))


def _smooth2d(rng: np.random.Generator, size: int = 28, cutoff: int = 5) -> np.ndarray:
    """Random smooth image via low-frequency Fourier synthesis."""
    spec = np.zeros((size, size), dtype=np.complex128)
    for u in range(cutoff):
        for v in range(cutoff):
            spec[u, v] = rng.normal() + 1j * rng.normal()
    img = np.real(np.fft.ifft2(spec))
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    return img


def make_mnist_like_dataset(
    seed: int = 0, samples_per_class: int = 500
) -> AnomalyDataset:
    """Per-class smooth prototype + per-sample elastic deformation +
    pixel noise, normalized to [0,1] like the paper's /255 MNIST."""
    rng = np.random.default_rng(seed)
    protos = [_smooth2d(rng) for _ in range(10)]
    xs, ys = [], []
    for ci in range(10):
        p = protos[ci]
        for _ in range(samples_per_class):
            # small random shift (elastic-ish deformation)
            dx, dy = rng.integers(-2, 3, size=2)
            img = np.roll(np.roll(p, dx, axis=0), dy, axis=1)
            img = img * rng.uniform(0.85, 1.15) + rng.normal(size=(28, 28)) * 0.05
            xs.append(np.clip(img, 0.0, 1.0).reshape(-1).astype(np.float32))
            ys.append(ci)
    return AnomalyDataset(
        name="mnist_like",
        x=np.stack(xs),
        y=np.asarray(ys, dtype=np.int32),
        class_names=_MNIST_CLASSES,
    )


DATASETS: dict[str, Callable[..., AnomalyDataset]] = {
    "driving": make_driving_dataset,
    "har": make_har_dataset,
    "mnist_like": make_mnist_like_dataset,
}


def make_dataset(name: str, seed: int = 0, **kw) -> AnomalyDataset:
    try:
        return DATASETS[name](seed=seed, **kw)
    except KeyError as e:
        raise ValueError(f"unknown dataset {name!r}; have {sorted(DATASETS)}") from e
