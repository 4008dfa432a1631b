"""Paper Figs. 8–17 on the port — ROC-AUC grids before and after the
cooperative model update against BP-NN3 / BP-NN5 / BP-NN3-FL, for the
HAR-like and MNIST-like data (the PyTorch counterpart of
``benchmarks/rocauc_grid.py``), on the card.

For every ordered pattern pair (p_A, p_B): train A on p_A and B on p_B,
evaluate ROC-AUC on A before and after merging B (trained patterns
normal, subsampled others anomalous, §5.3.1; ``pair_merge_eval``), and
compare the grid's average with the BP-NN baselines trained on
{p_A, p_B} jointly (``train_bpnn``, ``run_fedavg``, ``bpnn_auc``). The
generators are seeded as the reference seeds its keys (``seed·977 + t``
for the OS-ELM pairs, ``seed·31 + t`` for the BP-NN runs).

Asserted, as the reference asserts: the merge lifts the grid's average
AUC by more than 0.03.

    python benchmarks/torch_rocauc_grid.py [--device cpu]          # har, quick
    python benchmarks/torch_rocauc_grid.py --full [--device cpu]   # har and mnist_like, JSON
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.torch_common import (  # noqa: E402
    bench_device,
    edge_config,
    normalized_dataset,
    train_edge_device,
    where_line,
)
from repro_torch.baselines import bpnn3_config, bpnn5_config, run_fedavg, train_bpnn  # noqa: E402
from repro_torch.baselines.fedavg import FedAvgConfig  # noqa: E402
from repro_torch.data import (  # noqa: E402
    anomaly_eval_arrays,
    make_pattern_stream,
    train_test_split,
)
from repro_torch.scenarios import bpnn_auc, pair_merge_eval  # noqa: E402


def fit_bpnn(key: int, cfg, xa: np.ndarray, xb: np.ndarray, *, fedavg: bool, device):
    """A BP-NN on {p_A, p_B}: trained on the pooled samples, or by FedAvg
    over the two devices' streams (8 rounds of one local epoch)."""
    g = torch.Generator().manual_seed(key)
    if fedavg:
        return run_fedavg(g, cfg, [xa, xb], FedAvgConfig(rounds=8, local_epochs=1),
                          device=device)
    return train_bpnn(g, cfg, torch.as_tensor(np.concatenate([xa, xb]), device=device))


def oselm_grids(train, test, ecfg, *, trials: int = 3, seed: int = 0, device=None,
                trainer=train_edge_device):
    """Before/after AUC per ordered pattern pair, through the scenario
    evaluation path (``repro_torch.scenarios.pair_merge_eval``).
    ``trainer`` trains one edge device, with ``train_edge_device``'s
    signature."""
    n = train.n_classes
    before = np.zeros((n, n))
    after = np.zeros((n, n))
    for pa, pb in itertools.product(range(n), range(n)):
        aucs_b, aucs_a = [], []
        for t in range(trials):
            key = seed * 977 + t
            dev_a = trainer(train, pa, key=key, ecfg=ecfg, seed=seed + t, device=device)
            dev_b = trainer(train, pb, key=key, ecfg=ecfg, seed=seed + t + 7, device=device)
            b, a = pair_merge_eval(dev_a, dev_b, test, (pa, pb), seed=seed + t)
            aucs_b.append(b)
            aucs_a.append(a)
        before[pa, pb] = np.mean(aucs_b)
        after[pa, pb] = np.mean(aucs_a)
    return before, after


def bpnn_grid(train, test, cfg_builder, *, trials: int = 2, seed: int = 0, fedavg=False,
              device=None, fit=fit_bpnn):
    """The BP-NN's AUC per ordered pattern pair. ``fit`` trains one
    network, with ``fit_bpnn``'s signature."""
    n = train.n_classes
    grid = np.zeros((n, n))
    for pa, pb in itertools.product(range(n), range(n)):
        aucs = []
        for t in range(trials):
            xa = make_pattern_stream(train, pa, seed=seed + t)
            xb = make_pattern_stream(train, pb, seed=seed + t + 7)
            cfg = cfg_builder(train.n_features)
            params = fit(seed * 31 + t, cfg, xa, xb, fedavg=fedavg, device=device)
            x, y = anomaly_eval_arrays(test, [pa, pb], seed=seed + t)
            aucs.append(bpnn_auc(params, cfg, x, y))
        grid[pa, pb] = np.mean(aucs)
    return grid


def run(dataset: str = "har", *, trials: int = 2, seed: int = 0,
        include_bpnn5: bool = True, include_fl: bool = True, device=None) -> dict:
    ds = normalized_dataset(dataset, seed=seed, samples_per_class=420)
    train, test = train_test_split(ds, 0.8, seed=seed)
    ecfg = edge_config(dataset)

    before, after = oselm_grids(train, test, ecfg, trials=trials, seed=seed, device=device)
    res = {
        "dataset": dataset,
        "avg_before": float(before.mean()),
        "avg_after": float(after.mean()),
    }

    n1 = 64 if dataset == "mnist_like" else 256
    bp3 = bpnn_grid(train, test, lambda f: bpnn3_config(f, n1, batch=8, epochs=4),
                    trials=1, seed=seed, device=device)
    res["avg_bpnn3"] = float(bp3.mean())
    if include_bpnn5:
        bp5 = bpnn_grid(
            train, test,
            lambda f: bpnn5_config(f, n1, n1 // 2, n1, batch=8, epochs=4),
            trials=1, seed=seed, device=device,
        )
        res["avg_bpnn5"] = float(bp5.mean())
    if include_fl:
        fl = bpnn_grid(train, test, lambda f: bpnn3_config(f, n1, batch=8, epochs=1),
                       trials=1, seed=seed, fedavg=True, device=device)
        res["avg_bpnn3_fl"] = float(fl.mean())

    res["grids"] = {"before": before.tolist(), "after": after.tolist()}
    return res


def claims(r: dict) -> dict:
    """The paper's claims on one dataset's grid: the merge lifts AUC
    substantially (asserted) and lands near BP-NN3 (reported)."""
    lift = r["avg_after"] - r["avg_before"]
    return {"lift": lift, "lifted": lift > 0.03,
            "near_bp": abs(r["avg_after"] - r["avg_bpnn3"]) < 0.12}


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="har and mnist_like, 3 trials, BP-NN5 and FL: the grids as JSON")
    args = ap.parse_args(argv)
    device = bench_device(args.device)
    if args.full:
        return [json.dumps(run(ds, trials=3, device=device), indent=1)
                for ds in ("har", "mnist_like")]
    r = run("har", trials=1, include_bpnn5=False, include_fl=False, device=device)
    c = claims(r)
    assert c["lifted"], r
    return [
        f"rocauc_grid/har,{0:.1f},"
        f"before={r['avg_before']:.3f};after={r['avg_after']:.3f};"
        f"bpnn3={r['avg_bpnn3']:.3f};lift={c['lift']:.3f};near_bp={c['near_bp']}",
        f"# torch_rocauc_grid on {where_line(device)}",
    ]


if __name__ == "__main__":
    for line in main():
        print(line)
