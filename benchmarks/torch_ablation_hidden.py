"""Ablation on the port — detector quality and cost against the hidden
width Ñ (the PyTorch counterpart of ``benchmarks/ablation_hidden.py``;
it extends the paper's Table-4 Ñ ∈ {64, 128} axis with the accuracy
dimension), on the card.

For Ñ ∈ {16, 32, 64, 128, 256}: the post-merge ROC-AUC on HAR (420
samples a class, ridge 1e-2; the two-device scenario averaged over three
pattern pairs, each merged by ``cooperative_update(dev_a, to_uv(dev_b))``
and scored by ``ae_score``) and the U/V payload size — the
accuracy/communication trade the paper leaves implicit. Asserted, as the
reference asserts: the widest detector is no worse than the narrowest
by more than 0.05 AUC.

    python benchmarks/torch_ablation_hidden.py [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.torch_common import (  # noqa: E402
    bench_device,
    normalized_dataset,
    train_edge_device,
    where_line,
)
from repro_torch.configs import EdgeConfig  # noqa: E402
from repro_torch.core import ae_score, cooperative_update, to_uv  # noqa: E402
from repro_torch.data import anomaly_eval_arrays, roc_auc, train_test_split  # noqa: E402

PAIRS = [(3, 5), (0, 4), (1, 3)]  # (sitting, laying), (walking, standing), ...
WIDTHS = (16, 32, 64, 128, 256)


def run(widths=WIDTHS, seed: int = 0, *, device=None, trainer=train_edge_device) -> list[dict]:
    """One row a width. ``trainer`` trains one edge device, with
    ``train_edge_device``'s signature; each pair shares the basis drawn
    from ``key=seed``."""
    ds = normalized_dataset("har", seed=seed, samples_per_class=420)
    train, test = train_test_split(ds, 0.8, seed=seed)
    out = []
    for nh in widths:
        ecfg = EdgeConfig("har", ds.n_features, nh, "identity", ridge=1e-2)
        aucs = []
        for pa, pb in PAIRS:
            dev_a = trainer(train, pa, key=seed, ecfg=ecfg, seed=seed, device=device)
            dev_b = trainer(train, pb, key=seed, ecfg=ecfg, seed=seed + 7, device=device)
            merged = cooperative_update(dev_a, to_uv(dev_b))
            x, y = anomaly_eval_arrays(test, [pa, pb], seed=seed)
            scores = ae_score(merged, torch.as_tensor(x, device=merged.device))
            aucs.append(roc_auc(scores.cpu().numpy(), y))
        payload = 4 * (nh * nh + nh * ds.n_features)
        out.append({"n_hidden": nh, "auc": float(np.mean(aucs)), "payload_bytes": payload})
    return out


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = bench_device(args.device)
    rows = run(device=device)
    # wider is (weakly) better until saturation; payload grows quadratically+linearly
    assert rows[-1]["auc"] >= rows[0]["auc"] - 0.05, rows
    return [
        f"ablation_hidden/N{r['n_hidden']},{0:.1f},auc={r['auc']:.3f};payload={r['payload_bytes']}B"
        for r in rows
    ] + [f"# torch_ablation_hidden on {where_line(device)}"]


if __name__ == "__main__":
    for line in main():
        print(line)
