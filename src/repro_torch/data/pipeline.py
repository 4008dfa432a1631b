"""Dataset preparation; numpy copy of ``repro.data.pipeline``
(normalisation, class subsets, the stratified split, one device's pattern
stream, the §5.3.1 eval arrays, and the mesh federation's per-shard
streams and batches). The same seed gives the same arrays, bit for bit.
"""
from __future__ import annotations

from collections.abc import Iterator, Sequence
from typing import NamedTuple

import numpy as np

from repro_torch.data.synthetic import AnomalyDataset


def normalize_minmax(ds: AnomalyDataset) -> AnomalyDataset:
    """Per-feature min-max normalization to [0, 1] (for sigmoid-output
    BP-NNs; also stabilizes OS-ELM identity activations). The single
    normalization convention every paper-facing evaluation uses."""
    lo, hi = ds.x.min(0), ds.x.max(0)
    x = (ds.x - lo) / (hi - lo + 1e-6)
    return ds._replace(x=x.astype(np.float32))


def class_subset(ds: AnomalyDataset, classes: Sequence[int | str]) -> AnomalyDataset:
    """Subset to ``classes`` and REMAP labels: class ``classes[i]`` of
    ``ds`` becomes class ``i`` of the result. This is how a scenario
    carves its normal + held-out-anomaly pools out of a dataset whose
    interesting classes need not be contiguous (e.g. HAR's walking /
    sitting / standing homes with laying as the anomaly)."""
    ids = [
        ds.class_names.index(c) if isinstance(c, str) else int(c) for c in classes
    ]
    if len(set(ids)) != len(ids):
        raise ValueError(f"duplicate classes in subset: {classes!r}")
    for i in ids:
        if not 0 <= i < ds.n_classes:
            raise ValueError(f"class {i} outside dataset with {ds.n_classes} classes")
    xs, ys = [], []
    for new, old in enumerate(ids):
        x = ds.x[ds.y == old]
        xs.append(x)
        ys.append(np.full(len(x), new, dtype=np.int32))
    return AnomalyDataset(
        ds.name,
        np.concatenate(xs),
        np.concatenate(ys),
        tuple(ds.class_names[i] for i in ids),
    )


def train_test_split(
    ds: AnomalyDataset, train_frac: float = 0.8, seed: int = 0
) -> tuple[AnomalyDataset, AnomalyDataset]:
    """80/20 split as in the paper (§5.3.1), stratified per class."""
    rng = np.random.default_rng(seed)
    tr_idx, te_idx = [], []
    for ci in range(ds.n_classes):
        idx = np.flatnonzero(ds.y == ci)
        rng.shuffle(idx)
        cut = int(len(idx) * train_frac)
        tr_idx.append(idx[:cut])
        te_idx.append(idx[cut:])
    tr = np.concatenate(tr_idx)
    te = np.concatenate(te_idx)
    rng.shuffle(tr)
    rng.shuffle(te)
    return (
        AnomalyDataset(ds.name, ds.x[tr], ds.y[tr], ds.class_names),
        AnomalyDataset(ds.name, ds.x[te], ds.y[te], ds.class_names),
    )


def make_pattern_stream(
    ds: AnomalyDataset, pattern: int | str, *, seed: int = 0, limit: int | None = None
) -> np.ndarray:
    """The non-IID stream a single edge device observes: samples of one
    normal pattern only, shuffled."""
    x = ds.pattern(pattern).copy()
    rng = np.random.default_rng(seed)
    rng.shuffle(x)
    return x[:limit] if limit is not None else x


def anomaly_eval_arrays(
    test: AnomalyDataset,
    normal_patterns: Sequence[int],
    *,
    anomaly_ratio: float = 0.1,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """The paper's §5.3.1 protocol: trained patterns are normal test
    data; all others are anomalous, subsampled to 10% of the normal
    count. Returns (x, is_anomalous)."""
    rng = np.random.default_rng(seed)
    normal_mask = np.isin(test.y, np.asarray(list(normal_patterns)))
    x_norm = test.x[normal_mask]
    x_anom = test.x[~normal_mask]
    n_anom = max(1, int(len(x_norm) * anomaly_ratio))
    pick = rng.choice(len(x_anom), size=min(n_anom, len(x_anom)), replace=False)
    x_anom = x_anom[pick]
    x = np.concatenate([x_norm, x_anom])
    y = np.concatenate([np.zeros(len(x_norm)), np.ones(len(x_anom))]).astype(np.int32)
    return x, y


class ShardedStream(NamedTuple):
    """Per-shard non-IID streams for the mesh federation: shard i trains
    on pattern (i mod n_classes). Shapes: (shards, steps, features)."""

    xs: np.ndarray
    pattern_of_shard: np.ndarray  # (shards,)


def make_sharded_streams(
    ds: AnomalyDataset, n_shards: int, steps: int, *, seed: int = 0
) -> ShardedStream:
    rng = np.random.default_rng(seed)
    xs = np.empty((n_shards, steps, ds.n_features), dtype=np.float32)
    pats = np.empty(n_shards, dtype=np.int32)
    for s in range(n_shards):
        pat = s % ds.n_classes
        pool = ds.pattern(pat)
        idx = rng.integers(0, len(pool), size=steps)
        xs[s] = pool[idx]
        pats[s] = pat
    return ShardedStream(xs=xs, pattern_of_shard=pats)


def batched(x: np.ndarray, batch: int) -> Iterator[np.ndarray]:
    """Consecutive full batches of ``x``; a short tail is dropped."""
    for i in range(0, len(x) - batch + 1, batch):
        yield x[i : i + batch]
