"""Fleet-topology demo on the PyTorch/CUDA port: 128 virtual edge devices,
four merge topologies, async staleness, drift injection and traffic
accounting.

Simulates the paper's cooperative model update at fleet scale with
``repro_torch.fleet``: the whole fleet is one stacked ``OSELMState``
(trained through the fused ingest kernel), and each topology's merge is a
neighbour sum over the stacked (U, V) payloads on the merge kernels.

    PYTHONPATH=src python examples/torch_fleet_topologies.py [--devices 128] [--device cpu]

It runs on the CUDA card by default; ``--device cpu`` runs the kernels'
plain PyTorch versions instead.

Fleet API in one screen::

    fs    = make_fleet_streams(ds, D, steps, drift=schedule)  # non-IID deal
    fleet = init_fleet(gen, D, n_features, n_hidden, fs.x_init)
    fleet = fleet_train(fleet, xs)                    # fused k=1 ingest
    fleet = fleet_merge(fleet, star(D))               # Eq. 8 over the topology
    fleet = fleet_train_async(fleet, xs, topo, lags, rounds=4)  # stale merges
    cost  = topology_round_cost(topo, n_hidden, n_out)          # bytes/round
"""
import argparse

import numpy as np
import torch

from repro_torch.data import (
    AnomalyDataset,
    anomaly_eval_arrays,
    make_har_dataset,
    roc_auc,
    train_test_split,
)
from repro_torch.fleet import (
    StalenessSchedule,
    all_to_all,
    fedavg_total_cost,
    fleet_merge,
    fleet_score,
    fleet_train,
    fleet_to_uv,
    fleet_train_async,
    hierarchical,
    init_fleet,
    make_fleet_streams,
    random_drift_schedule,
    ring,
    star,
    topology_round_cost,
)
from repro_torch.kernels import from_uv_solve, launch_counts

N_HIDDEN = 32
N_KEEP = 2  # the fleet trains on 2 HAR patterns; the other 4 stay anomalous


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=128)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    n_dev = args.devices

    ds = make_har_dataset(seed=0, samples_per_class=150)
    lo, hi = ds.x.min(0), ds.x.max(0)
    ds = ds._replace(x=((ds.x - lo) / (hi - lo + 1e-6)).astype(np.float32))
    train, test = train_test_split(ds, 0.8, seed=0)
    keep = train.y < N_KEEP
    sub = AnomalyDataset(train.name, train.x[keep], train.y[keep], train.class_names[:N_KEEP])
    x_eval, y_eval = anomaly_eval_arrays(test, list(range(N_KEEP)), seed=0)

    # non-IID deal with drift: a quarter of the fleet switches pattern
    # mid-stream (concept drift the cooperative update has to absorb)
    drift = random_drift_schedule(n_dev, args.steps, N_KEEP, frac=0.25, seed=0)
    fs = make_fleet_streams(sub, n_dev, args.steps, n_init=2 * N_HIDDEN, drift=drift, seed=0)
    print(f"fleet: {n_dev} devices, {args.steps}-step streams, {len(drift)} drift events")

    def fresh_fleet():
        return init_fleet(torch.Generator().manual_seed(0), n_dev, ds.n_features, N_HIDDEN,
                          fs.x_init, activation="identity", ridge=1e-3, device=args.device)

    fleet0 = fresh_fleet()
    dev = fleet0.p.device
    xs = torch.as_tensor(fs.xs, device=dev)
    x_eval_t = torch.as_tensor(x_eval, device=dev)
    fleet0 = fleet_train(fleet0, xs)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")

    def mean_auc(states):
        scores = fleet_score(states, x_eval_t)[:16].cpu().numpy()
        return float(np.mean([roc_auc(s, y_eval) for s in scores]))

    topologies = [all_to_all(n_dev), star(n_dev), ring(n_dev, hops=2),
                  hierarchical(n_dev, max(1, n_dev // 8))]
    fedavg = fedavg_total_cost(n_dev, 10, ds.n_features, N_HIDDEN, ds.n_features)
    print(f"\n{'topology':<16}{'payloads':>9}{'KiB/round':>11}{'mean AUC':>10}")
    for topo in topologies:
        merged = fleet_merge(fleet0, topo, ridge=1e-3)
        cost = topology_round_cost(topo, N_HIDDEN, ds.n_features)
        print(f"{topo.name:<16}{cost.payloads:>9}{cost.bytes_total / 1024:>11.0f}"
              f"{mean_auc(merged):>10.3f}")
    print(f"{'fedavg_r10':<16}{fedavg.payloads:>9}{fedavg.bytes_total / 1024:>11.0f}{'—':>10}")

    # async: devices publish late by up to 3 rounds, a tenth of them always 3
    lags = StalenessSchedule.random(n_dev, max_lag=3, seed=1, stragglers=0.1)
    fleet1 = fleet_train_async(fresh_fleet(), xs, star(n_dev), lags, rounds=4, ridge=1e-3)
    print(f"\nasync star, lags ≤ 3 rounds ({lags.max_lag} max): "
          f"post-sync mean AUC = {mean_auc(fleet1):.3f}")

    # the open ring's merge as one fused kernel (neighbour sum and solve in
    # one launch per device tile, so the merged (U, V) never reaches device
    # memory) against the unfused route: the banded mix kernel, then one
    # Gauss-Jordan solve per device
    topo = ring(n_dev, hops=2)
    fused = fleet_merge(fleet0, topo, ridge=1e-3)
    uv = fleet_to_uv(fleet0, ridge=1e-3)
    mixed = topo.mix(torch.cat([uv.u, uv.v], dim=2))
    _, beta = from_uv_solve(mixed[:, :, :N_HIDDEN], mixed[:, :, N_HIDDEN:], ridge=1e-3)
    diff = float((beta - fused.beta).abs().max())
    counts = {k: v for k, v in launch_counts().items() if v}
    print(f"fused ring merge vs banded mix + solve: max |Δβ| = {diff:.2e}")
    print(f"kernel launches: {counts or 'none (plain versions on the CPU)'}")


if __name__ == "__main__":
    main()
