"""Paper Fig. 18 on the port: one-shot merging against sequential
training, on the card.

    python benchmarks/torch_convergence.py [--device cpu]

Device-A trains on 'laying', Device-B on 'walking' (har, Ñ = 128). The
merge hands A's knowledge to B at once; sequential k=1 training of the
laying pattern on B (``ae_train_step``: the hidden_proj, matmul_atb and
rank1_add kernels) needs many updates to reach the same loss. Reports
the crossover count (the first update, checked every ``eval_every``, at
which B's loss on held-out laying samples is within 10 % of the merged
model's), and the card's time for the merge and for the sequential run.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.torch_common import (  # noqa: E402
    edge_config,
    normalized_dataset,
    timed_ms,
    train_edge_device,
    where_line,
)
from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.core import ae_score, ae_train_step, cooperative_update, to_uv  # noqa: E402
from repro_torch.data import make_pattern_stream, train_test_split  # noqa: E402


def run(seed: int = 0, eval_every: int = 50, max_updates: int = 2000, *, device=None) -> dict:
    device = resolve_device(device)
    ds = normalized_dataset("har", seed=seed)
    train, test = train_test_split(ds, 0.8, seed=seed)
    ecfg = edge_config("har")  # Ñ = 128 as in §5.5
    dev_a = train_edge_device(train, "laying", key=seed, ecfg=ecfg, seed=seed, device=device)
    dev_b = train_edge_device(train, "walking", key=seed, ecfg=ecfg, seed=seed + 1,
                              device=device)
    x_eval = torch.as_tensor(test.pattern("laying")[:64], device=device)

    # one-shot merge: B absorbs A
    uv_a = to_uv(dev_a)
    merged = cooperative_update(dev_b, uv_a)
    merge_loss = float(ae_score(merged, x_eval).mean())

    # conventional sequential training of laying on B
    stream = make_pattern_stream(train, "laying", seed=seed + 2)
    stream = np.concatenate([stream] * (max_updates // len(stream) + 1))[:max_updates]
    xs = torch.as_tensor(stream, device=device)
    st, curve, crossover = dev_b, [], None
    for i in range(max_updates):
        st = ae_train_step(st, xs[i])
        if (i + 1) % eval_every == 0:
            loss = float(ae_score(st, x_eval).mean())
            curve.append((i + 1, loss))
            if loss <= merge_loss * 1.1:
                crossover = i + 1
                break
    steps = crossover or max_updates

    def sequential():
        s = dev_b
        for i in range(steps):
            s = ae_train_step(s, xs[i])
        return s

    return {
        "merge_loss": merge_loss,
        "curve": curve,
        "crossover_updates": crossover,
        "loss_before": float(ae_score(dev_b, x_eval).mean()),
        "merge_ms": timed_ms(lambda: cooperative_update(dev_b, uv_a), device),
        "sequential_ms": timed_ms(sequential, device, warmup=1, iters=3),
        # what ran: two boots and ingests, then the k=1 steps of the search
        # and of the timed repeats (one warmup, three timed)
        "boots": 2,
        "k1_steps": 5 * steps,
    }


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    r = run(device=device)
    assert r["merge_loss"] < r["loss_before"] / 5, r
    cross = r["crossover_updates"]
    assert cross is None or cross >= 50  # the merge is not beaten at once
    where = where_line(device)
    return [
        f"device: {where}",
        f"convergence/har: merge_loss={r['merge_loss']:.6f} before={r['loss_before']:.6f}"
        f" crossover_updates={cross}; merge {r['merge_ms']:.4f} ms,"
        f" {cross or 'all'} sequential k=1 updates {r['sequential_ms']:.3f} ms",
    ]


if __name__ == "__main__":
    for line in main():
        print(line)
