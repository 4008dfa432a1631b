"""The paper's backpropagation baselines (port of ``repro.baselines``):
BP-NN3/5 autoencoders and BP-NN3-FL (FedAvg)."""
from repro_torch.baselines.bpnn import (
    BPNNConfig,
    bpnn3_config,
    bpnn5_config,
    bpnn_loss,
    bpnn_predict,
    bpnn_score,
    init_bpnn,
    train_bpnn,
)
from repro_torch.baselines.fedavg import FedAvgConfig, average_params, fedavg_round, run_fedavg

__all__ = [
    "BPNNConfig", "bpnn3_config", "bpnn5_config", "init_bpnn",
    "bpnn_predict", "bpnn_loss", "bpnn_score", "train_bpnn",
    "FedAvgConfig", "average_params", "fedavg_round", "run_fedavg",
]
