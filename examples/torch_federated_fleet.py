"""Federated fleet simulation on the PyTorch/CUDA port: N edge devices, a
server, client selection, and a poisoned client that is left out (paper
§4.2 and refs [19][20]).

    PYTHONPATH=src python examples/torch_federated_fleet.py [--devices 6] [--device cpu]

It runs on the CUDA card by default; ``--device cpu`` runs the kernels'
plain PyTorch versions instead.
"""
import argparse

import numpy as np
import torch

from repro_torch.data import (
    anomaly_eval_arrays,
    make_har_dataset,
    make_pattern_stream,
    roc_auc,
    train_test_split,
)
from repro_torch.federated import (
    EdgeDevice,
    FederationServer,
    cooperative_round,
    loss_threshold_selection,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=6)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ds = make_har_dataset(seed=0, samples_per_class=300)
    lo, hi = ds.x.min(0), ds.x.max(0)
    ds = ds._replace(x=((ds.x - lo) / (hi - lo + 1e-6)).astype(np.float32))
    train, test = train_test_split(ds, 0.8, seed=0)

    devices = []
    for i in range(args.devices):
        xs = make_pattern_stream(train, i % ds.n_classes, seed=i)
        # one seed for every device: the shared basis the merge needs
        dev = EdgeDevice(f"edge-{i}", torch.Generator().manual_seed(0), ds.n_features, 64,
                         xs[:128], ridge=1e-3, device=args.device)
        dev.train(xs[128:])
        devices.append(dev)

    # poison the last device (ref [20])
    rng = np.random.default_rng(0)
    devices[-1].train(rng.normal(size=(200, ds.n_features)).astype(np.float32) * 40)

    # each device reports a validation loss on its own pattern
    local_losses = {}
    for i, dev in enumerate(devices):
        xp = test.pattern(i % ds.n_classes)[:32]
        local_losses[dev.device_id] = float(dev.score(xp).mean())
    print("local validation losses:", {k: f"{v:.3f}" for k, v in local_losses.items()})

    server = FederationServer()
    select = loss_threshold_selection(local_losses, max_loss=0.5)
    cooperative_round(devices, server, select=select)
    chosen = select([d.device_id for d in devices])
    print(f"selected clients: {chosen} (poisoned edge-{args.devices - 1} excluded)")
    assert f"edge-{args.devices - 1}" not in chosen

    # every selected device now covers every selected pattern
    patterns = sorted({i % ds.n_classes for i in range(len(chosen))})
    x_eval, y_eval = anomaly_eval_arrays(test, patterns, seed=1)
    for dev in devices[:3]:
        auc = roc_auc(dev.score(x_eval), y_eval)
        print(f"{dev.device_id}: post-merge ROC-AUC over {len(patterns)} patterns = {auc:.3f}")
    print(f"comm totals: {server.log.uploads} uploads / {server.log.downloads} downloads, "
          f"{server.log.bytes_up + server.log.bytes_down} bytes")


if __name__ == "__main__":
    main()
