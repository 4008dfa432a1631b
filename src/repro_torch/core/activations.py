"""Activation registry for ELM/OS-ELM hidden layers (port of
``repro.core.activations``).

The paper (Table 3) uses Sigmoid for UAH-DriveSet and Identity for
HAR/MNIST. The same six names as the reference are built in, and
``register_activation`` adds or replaces one, as the reference's does.
The CUDA kernels apply a built-in activation under the code
``ACTIVATION_CODES`` gives it, while the registry still holds the
built-in function under that name (``kernel_code``); for any other name
they project with the identity code and the wrapper applies the
registered function to the projection.
"""
from __future__ import annotations

from typing import Callable

import torch

Activation = Callable[[torch.Tensor], torch.Tensor]

_BUILTIN: dict[str, Activation] = {
    "identity": lambda x: x,
    "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "tanh": torch.tanh,
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "gelu": lambda x: 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x**3))),
    "silu": lambda x: x / (1.0 + torch.exp(-x)),
}
_REGISTRY: dict[str, Activation] = dict(_BUILTIN)

# the integer each built-in activation carries into the CUDA kernels
ACTIVATION_CODES = {name: i for i, name in enumerate(_BUILTIN)}


def get_activation(name: str) -> Activation:
    try:
        return _REGISTRY[name]
    except KeyError as e:
        raise ValueError(f"unknown activation {name!r}; have {sorted(_REGISTRY)}") from e


def register_activation(name: str, fn: Activation) -> None:
    _REGISTRY[name] = fn


def kernel_code(name: str) -> int | None:
    """The kernels' code for ``name`` while the registry holds the built-in
    function under it; None for a registered function (the kernel then
    projects with the identity code and the wrapper applies the function).
    Raises on an unknown name."""
    fn = get_activation(name)
    return ACTIVATION_CODES[name] if _BUILTIN.get(name) is fn else None
