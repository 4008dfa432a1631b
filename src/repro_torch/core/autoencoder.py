"""OS-ELM autoencoder anomaly score (paper §3.4); port of
``repro.core.autoencoder.ae_score``."""
from __future__ import annotations

import torch

from repro_torch.core.oselm import OSELMState, oselm_loss


def ae_score(state: OSELMState, x: torch.Tensor) -> torch.Tensor:
    """Reconstruction MSE per sample; high = anomalous."""
    return oselm_loss(state, x, x)
