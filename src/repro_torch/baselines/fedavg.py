"""BP-NN3-FL, the traditional federated learning baseline (paper
§5.3.1); port of ``repro.baselines.fedavg``.

FedAvg [McMahan et al., ref 10]: each communication round every client
trains the shared global model on its own pattern, the server averages
the locally trained parameter trees, and the average is the next round's
global model. The paper runs R = 50 rounds, the comparison point for the
one-shot OS-ELM merge.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.baselines.bpnn import BPNNConfig, init_bpnn, train_bpnn
from repro_torch.optim import tree_map


class FedAvgConfig(NamedTuple):
    rounds: int = 50
    local_epochs: int = 1


def average_params(trees: Sequence) -> list:
    """The FedAvg server step: the elementwise mean of the clients' trees."""
    return tree_map(lambda *xs: torch.stack(xs).mean(0), *trees)


def fedavg_round(
    generator: torch.Generator,
    global_params,
    cfg: BPNNConfig,
    client_data: Sequence[torch.Tensor],
    local_epochs: int = 1,
):
    """One communication round: each client trains from the global model
    on its own data (shuffles drawn from ``generator`` in client order),
    then the server averages."""
    return average_params([
        train_bpnn(generator, cfg, xc, params=global_params, epochs=local_epochs)
        for xc in client_data
    ])


def run_fedavg(
    generator: torch.Generator,
    cfg: BPNNConfig,
    client_data: Sequence[np.ndarray],
    fl: FedAvgConfig = FedAvgConfig(),
    *,
    device: str | torch.device | None = None,
    params=None,
):
    """Full BP-NN3-FL training on ``device`` (the card unless
    ``device="cpu"``): R rounds of local training and averaging, from
    ``params`` or, when None, from a network drawn from ``generator``."""
    device = resolve_device(device)
    data = [torch.as_tensor(np.asarray(c, np.float32), device=device) for c in client_data]
    global_params = init_bpnn(generator, cfg, device=device) if params is None else params
    for _ in range(fl.rounds):
        global_params = fedavg_round(generator, global_params, cfg, data, fl.local_epochs)
    return global_params
