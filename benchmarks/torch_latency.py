"""Paper Table 4 on the port: training, prediction and merging latency
[ms] of one OS-ELM device (561 features, Ñ = 64 and 128) against
BP-NN3-FL, on the card.

    python benchmarks/torch_latency.py [--device cpu]

OS-ELM: one k=1 training step (``oselm_step_k1``: the hidden_proj,
matmul_atb and rank1_add kernels), one prediction (``ae_score`` of one
sample) and one cooperative update with a remote (U, V). BP-NN3-FL: one
Adam step at batch 1, one prediction, and one FedAvg merge of two
clients, which it pays every one of R = 50 rounds where OS-ELM merges
once. Times are medians of CUDA-event spans around each call; on the
CPU (``--device cpu``, for a rehearsal) they are host-clock times and
not the card's.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmarks.torch_common import timed_ms, where_line  # noqa: E402
from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.baselines import average_params, bpnn3_config, bpnn_loss, init_bpnn  # noqa: E402
from repro_torch.baselines.bpnn import bpnn_grads  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ae_score,
    cooperative_update,
    init_autoencoder,
    oselm_step_k1,
    to_uv,
)
from repro_torch.optim import adam, tree_map  # noqa: E402

ROUNDS = 50  # the paper's BP-NN3-FL communication rounds


def oselm_latencies(n_features: int = 561, n_hidden: int = 64, seed: int = 0, *,
                    device=None, iters: int = 50) -> dict:
    device = resolve_device(device)
    x = torch.randn((4 * n_hidden, n_features), generator=torch.Generator().manual_seed(seed))
    st = init_autoencoder(torch.Generator().manual_seed(seed), n_features, n_hidden, x,
                          activation="identity", ridge=1e-3, device=device)
    x1 = x[0].to(device)
    uv = to_uv(st)
    return {
        "train_ms": timed_ms(lambda: oselm_step_k1(st, x1, x1), device, iters=iters),
        "predict_ms": timed_ms(lambda: ae_score(st, x1[None, :]), device, iters=iters),
        "merge_ms": timed_ms(lambda: cooperative_update(st, uv), device, iters=iters),
        "boots": 1,                  # what ran: one Eq. 13 boot and the timed k=1 steps
        "k1_steps": 2 + iters,       # (two warmup calls)
    }


def bpnn_fl_latencies(n_features: int = 561, n_hidden: int = 64, seed: int = 0, *,
                      device=None, iters: int = 50) -> dict:
    device = resolve_device(device)
    cfg = bpnn3_config(n_features, n_hidden, batch=1, epochs=1)
    params = init_bpnn(torch.Generator().manual_seed(seed), cfg, device=device)
    opt = adam(cfg.lr)
    opt_state = opt.init(params)
    x1 = torch.randn((1, n_features), generator=torch.Generator().manual_seed(seed)).to(device)
    clients = [tree_map(torch.clone, params) for _ in range(2)]
    return {
        "train_ms": timed_ms(lambda: opt.update(bpnn_grads(params, cfg, x1), opt_state, params),
                             device, iters=iters),
        "predict_ms": timed_ms(lambda: bpnn_loss(params, cfg, x1), device, iters=iters),
        "merge_per_round_ms": timed_ms(lambda: average_params(clients), device, iters=iters),
        "rounds": ROUNDS,
    }


def run(n_hidden: int, *, device=None, iters: int = 50) -> dict:
    os_lat = oselm_latencies(n_hidden=n_hidden, device=device, iters=iters)
    bp_lat = bpnn_fl_latencies(n_hidden=n_hidden, device=device, iters=iters)
    return {
        "n_hidden": n_hidden,
        "oselm": os_lat,
        "bpnn3_fl": bp_lat,
        "oselm_total_merge_ms": os_lat["merge_ms"],                       # one-shot
        "fl_total_merge_ms": bp_lat["merge_per_round_ms"] * bp_lat["rounds"],
    }


def table_lines(rows: list[dict]) -> list[str]:
    lines = []
    for r in rows:
        o, b = r["oselm"], r["bpnn3_fl"]
        lines.append(
            f"latency/N{r['n_hidden']}: OS-ELM train {o['train_ms']:.4f} ms, predict "
            f"{o['predict_ms']:.4f} ms, merge {o['merge_ms']:.4f} ms (once);"
            f" BP-NN3-FL train {b['train_ms']:.4f} ms, predict {b['predict_ms']:.4f} ms,"
            f" merge {b['merge_per_round_ms']:.4f} ms per round,"
            f" {r['fl_total_merge_ms']:.3f} ms over {b['rounds']} rounds;"
            f" one-shot merge cheaper: {r['oselm_total_merge_ms'] < r['fl_total_merge_ms']}")
    return lines


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    where = where_line(device)
    return [f"device: {where}"] + table_lines([run(n, device=device) for n in (64, 128)])


if __name__ == "__main__":
    for line in main():
        print(line)
