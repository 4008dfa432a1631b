"""Resident runtime demo on the PyTorch/CUDA port: online drift detection,
drift-adaptive merges and a restart from a snapshot.

A 16-device fleet serves non-IID HAR streams tick by tick. Mid-stream a
quarter of the devices drift to a held-out activity pattern. The runtime
flags each drift from the device's own loss trajectory within a few
ticks, quarantines the drifted devices out of the cooperative updates,
keeps merging the healthy ones, and snapshots the whole fleet; a fresh
runtime then restores the snapshot and resumes where the first stopped.

    PYTHONPATH=src python examples/torch_runtime_drift.py [--device cpu]

It runs on the CUDA card by default; ``--device cpu`` runs the kernels'
plain PyTorch versions instead.
"""
import argparse
import tempfile

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
    fleet_score,
    init_fleet,
    make_fleet_streams,
    random_drift_schedule,
    ring,
)
from repro_torch.kernels import launch_counts
from repro_torch.runtime import FleetRuntime, GovernorConfig, RuntimeConfig, TickFeed

D, HIDDEN, BATCH, TICKS, KEEP = 16, 16, 2, 160, 2


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ds = make_har_dataset(seed=0, samples_per_class=150)
    lo, hi = ds.x.min(0), ds.x.max(0)
    ds = ds._replace(x=((ds.x - lo) / (hi - lo + 1e-6)).astype(np.float32))
    train, test = train_test_split(ds, 0.8, seed=0)
    sub = train.y < KEEP + 1
    train3 = AnomalyDataset(train.name, train.x[sub], train.y[sub], train.class_names[: KEEP + 1])

    steps = TICKS * BATCH
    drift = random_drift_schedule(D, steps, KEEP + 1, frac=0.25, seed=2, home_classes=KEEP,
                                  targets=(KEEP,))
    fs = make_fleet_streams(train3, D, steps, n_init=2 * HIDDEN, drift=drift, seed=0,
                            n_assign=KEEP)
    feed = TickFeed(fs, BATCH)
    print(f"{D} devices × {feed.n_ticks} ticks; scheduled drift (device→tick): "
          f"{feed.drift_ticks()}")

    def fleet():
        return init_fleet(torch.Generator().manual_seed(0), D, ds.n_features, HIDDEN,
                          fs.x_init, activation="identity", ridge=1e-3, device=args.device)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        cfg = RuntimeConfig(topology=ring(D, hops=2), ridge=1e-3,
                            governor=GovernorConfig(merge_every=20),
                            snapshot_every=50, snapshot_dir=ckpt_dir)
        rt = FleetRuntime(fleet(), cfg, device=args.device)
        for t in range(feed.n_ticks):
            rep = rt.tick(feed.tick_batch(t))
            for dev in np.flatnonzero(rep.fresh_detections):
                print(f"tick {t:3d}: DRIFT DETECTED on device {dev} "
                      f"(loss {rep.losses[dev]:.4f})")
            if rep.decision.merge:
                q = D - rep.decision.participants
                print(f"tick {t:3d}: merge #{rt.merge_round} — "
                      f"{rep.decision.participants}/{D} participate ({q} quarantined), "
                      f"{rep.decision.round_bytes / 1e3:.0f} kB, "
                      f"{rep.merge_seconds * 1e3:.1f} ms")
        if rt.device.type == "cuda":
            print(f"kernel launches: {({k: v for k, v in launch_counts().items() if v})}")

        # the drifted concept (pattern KEEP) is what the evaluation labels
        # anomalous: the quarantine kept it out of the merges
        sub_t = test.y < KEEP + 1
        test3 = AnomalyDataset(test.name, test.x[sub_t], test.y[sub_t],
                               test.class_names[: KEEP + 1])
        x_eval, y_eval = anomaly_eval_arrays(test3, list(range(KEEP)), anomaly_ratio=0.3, seed=0)
        clean = [d for d in range(D) if d not in feed.drift_ticks()]
        scores = fleet_score(rt.states, torch.as_tensor(x_eval, device=rt.device)).cpu().numpy()
        aucs = [roc_auc(scores[d], y_eval) for d in clean]
        print(f"clean-device anomaly AUC vs the drifted concept: "
              f"mean {np.mean(aucs):.4f}, min {np.min(aucs):.4f}")

        # restart: snapshot the final state, then a fresh runtime resumes
        # from it with the fleet bit for bit
        path = rt.snapshot()
        rt2 = FleetRuntime(fleet(), cfg, device=args.device)
        resumed = rt2.restore()
        same = torch.equal(rt2.states.beta, rt.states.beta) and torch.equal(rt2.states.p,
                                                                             rt.states.p)
        print(f"restored snapshot {path.name} ({path.stat().st_size} bytes) at tick {resumed};"
              f" fleet state intact: {same}")
        assert same and resumed == rt.tick_no


if __name__ == "__main__":
    main()
