"""The paper's own edge-device configuration (Table 3); a copy of
``repro.configs.oselm_edge``.

OS-ELM autoencoder hyperparameters per dataset: activation G, init
distribution p(x), hidden width Ñ, loss L=MSE, batch k=1, epochs E=1,
forget factor λ=1, two detector instances [18].
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EdgeConfig:
    dataset: str
    n_features: int
    n_hidden: int
    activation: str
    init_dist: str = "uniform"
    batch_k: int = 1
    epochs: int = 1
    forget: float = 1.0
    n_instances: int = 2
    ridge: float = 1e-3  # f32 guard; paper runs f64 with ridge 0


EDGE_CONFIGS: dict[str, EdgeConfig] = {
    "driving": EdgeConfig("driving", 225, 16, "sigmoid"),
    "har": EdgeConfig("har", 561, 128, "identity"),
    "mnist_like": EdgeConfig("mnist_like", 784, 64, "identity"),
}
