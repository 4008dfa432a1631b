"""Activation registry for ELM/OS-ELM hidden layers (port of
``repro.core.activations``).

The paper (Table 3) uses Sigmoid for UAH-DriveSet and Identity for
HAR/MNIST. The same six names as the reference are registered; the CUDA
ingest kernel implements each under the code ``ACTIVATION_CODES`` gives.
"""
from __future__ import annotations

from typing import Callable

import torch

Activation = Callable[[torch.Tensor], torch.Tensor]

_REGISTRY: dict[str, Activation] = {
    "identity": lambda x: x,
    "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "tanh": torch.tanh,
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "gelu": lambda x: 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x**3))),
    "silu": lambda x: x / (1.0 + torch.exp(-x)),
}

# the integer each activation carries into the CUDA ingest kernel
ACTIVATION_CODES = {name: i for i, name in enumerate(_REGISTRY)}


def get_activation(name: str) -> Activation:
    try:
        return _REGISTRY[name]
    except KeyError as e:
        raise ValueError(f"unknown activation {name!r}; have {sorted(_REGISTRY)}") from e
