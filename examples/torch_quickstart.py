"""Quickstart on the PyTorch/CUDA port: the paper in a minute.

Two edge devices train OS-ELM autoencoders on different normal patterns
(non-IID); one cooperative model update (Eqs. 8 and 15) merges them; both
devices then recognise both patterns. It ends with the ROC-AUC lift.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

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
from repro_torch.federated import EdgeDevice, FederationServer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ds = make_har_dataset(seed=0, samples_per_class=300)
    lo, hi = ds.x.min(0), ds.x.max(0)
    ds = ds._replace(x=((ds.x - lo) / (hi - lo + 1e-6)).astype(np.float32))
    train, test = train_test_split(ds, 0.8, seed=0)
    n_hidden = 64

    def build(device_id, pattern):
        xs = make_pattern_stream(train, pattern, seed=1)
        # one seed for both devices: the shared basis the merge needs
        dev = EdgeDevice(device_id, torch.Generator().manual_seed(0), ds.n_features, n_hidden,
                         xs[:128], ridge=1e-3, device=args.device)
        dev.train(xs[128:])
        return dev

    dev_a, dev_b = build("A", "sitting"), build("B", "laying")

    x_eval, y_eval = anomaly_eval_arrays(test, [3, 5], seed=0)  # sitting, laying
    auc_before = roc_auc(dev_a.score(x_eval), y_eval)
    laying = test.pattern("laying")[:32]
    print(f"loss of 'laying' on A before merge: {dev_a.score(laying).mean():.4f}")

    # --- the cooperative model update (paper §4.2) ---------------------
    server = FederationServer()
    dev_a.share(server)
    dev_b.share(server)
    dev_a.merge_from(server, ["B"])          # one shot, no rounds
    dev_b.merge_from(server, ["A"])

    print(f"loss of 'laying' on A after merge:  {dev_a.score(laying).mean():.4f}")
    auc_after = roc_auc(dev_a.score(x_eval), y_eval)
    print(f"ROC-AUC on A: {auc_before:.3f} -> {auc_after:.3f}")
    print(f"payload exchanged: {server.log.bytes_up} bytes up "
          f"({server.log.uploads} uploads) — independent of data size")
    assert auc_after >= auc_before
    # A and B hold the same model now (paper §5.2.1)
    np.testing.assert_allclose(dev_a.state.beta.cpu().numpy(), dev_b.state.beta.cpu().numpy(),
                               atol=1e-4)
    print("devices converged to the identical merged model ✓")


if __name__ == "__main__":
    main()
