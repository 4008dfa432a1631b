"""How far a reduced config's f32 gradients sit from the same model's f64
gradients, on the CPU: the rounding floor under any check that holds one
f32 run's gradients to another's (``chip_smoke.py`` phase 20 (c) holds the
card's to the CPU's at ``TRAIN_GRAD_REL`` of each leaf's largest). Run from
the root of a checkout:

    PYTHONPATH=src python3 tools/train_grad_spread.py [--arch hymba-1.5b] [--seq 200]

It draws the weights and tokens as phase 20 (c) does (``torch.Generator``
seed 0, numpy seed 20, B 4), takes ``lm_loss``'s gradients in f32 and in
f64 and prints each of the five worst leaves' max |f32 − f64| / max |f64|.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--seq", type=int, default=200)
    args = ap.parse_args()

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import init_params
    from repro_torch.optim import tree_leaves

    def f64(tree):
        return {k: f64(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.double()

    def names(tree, prefix=""):
        if isinstance(tree, dict):
            return [n for k in sorted(tree) for n in names(tree[k], f"{prefix}/{k}")]
        return [prefix]

    cfg = get_config(args.arch).reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(20)
    tokens, labels = (torch.as_tensor(rng.integers(0, cfg.vocab, (4, args.seq))) for _ in range(2))
    _, _, g32 = loss_and_grads(cfg, params, tokens, labels)
    _, _, g64 = loss_and_grads(cfg, f64(params), tokens, labels)
    rels = [float((a.double() - b).abs().max() / b.abs().max())
            for a, b in zip(tree_leaves(g32), tree_leaves(g64))]
    leaves = names(g32)
    for i in np.argsort(rels)[::-1][:5]:
        print(f"{args.arch} reduced, S {args.seq}: {leaves[i]} f32 against f64 {rels[i]:.3e}"
              " of its largest")
    return 0


if __name__ == "__main__":
    sys.exit(main())
