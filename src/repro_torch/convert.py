"""Carry state across from the JAX package as numpy arrays.

The reference keeps a fleet as a stacked pytree whose leaves all carry
the device axis, the shared basis included. These functions take those
leaves as numpy arrays (``np.asarray`` of each leaf) and build the
port's counterparts on a given device. This module imports neither JAX
nor the JAX package: it only reads arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.e2lm import UV
from repro_torch.core.elm import SLFNParams
from repro_torch.core.oselm import OSELMState
from repro_torch.kernels.fleet_ingest import validate_shared_basis
from repro_torch.optim import OptState
from repro_torch.runtime.detector import DetectorState


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def oselm_state_from_numpy(
    alpha, bias, beta, p, *, activation: str, forget: float,
    device: str | torch.device | None = None,
) -> OSELMState:
    """One device's state, or a fleet's. A stacked basis (D, n, Ñ) must be
    one basis broadcast over the fleet; the port keeps one copy of it."""
    device = resolve_device(device)
    alpha, bias = np.asarray(alpha), np.asarray(bias)
    if alpha.ndim == 3:
        validate_shared_basis(alpha)
        alpha, bias = alpha[0], bias[0]
    return OSELMState(
        params=SLFNParams(alpha=_f32(alpha, device), bias=_f32(bias, device)),
        beta=_f32(beta, device), p=_f32(p, device),
        activation=activation, forget=float(forget),
    )


def uv_from_numpy(u, v, *, device: str | torch.device | None = None) -> UV:
    """An E²LM payload (U, V), one device's or stacked."""
    device = resolve_device(device)
    return UV(u=_f32(u, device), v=_f32(v, device))


def bpnn_params_from_numpy(params, *, device: str | torch.device | None = None) -> list[dict]:
    """BP-NN parameters: a list of {"w", "b"} layers of arrays."""
    device = resolve_device(device)
    return [{k: _f32(leaf, device) for k, leaf in layer.items()} for layer in params]


def _tensor(x, device) -> torch.Tensor:
    """A numpy array as a tensor of the same type; bf16 (``ml_dtypes``'
    bfloat16, as ``np.asarray`` gives a JAX bf16 array) goes over by its
    bits."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(x.copy()).to(device)


def model_params_from_numpy(tree, *, device: str | torch.device | None = None) -> dict:
    """A model's parameters (``repro.models.init_params``'s pytree with each
    leaf as ``np.asarray``) as the port's nested dict, leaf for leaf in the
    same stacked per-kind layout and type."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: model_params_from_numpy(v, device=device) for k, v in tree.items()}
    return _tensor(tree, device)


def _tree_from_numpy(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_from_numpy(v, device) for v in tree)
    return _tensor(tree, device)


def opt_state_from_numpy(step, mu, nu, *, device: str | torch.device | None = None) -> OptState:
    """An optimizer's state (``repro.optim.OptState``: the step count and the
    moment trees, each leaf as ``np.asarray``, or None where the optimizer
    keeps none) as the port's ``OptState``, leaf for leaf in the same
    structure and type, so that a step can start from a reference state."""
    device = resolve_device(device)
    return OptState(step=int(np.asarray(step)), mu=_tree_from_numpy(mu, device),
                    nu=_tree_from_numpy(nu, device))


def detector_state_from_numpy(
    ewma, mean, var, count, drifted, recovery, *, device: str | torch.device | None = None
) -> DetectorState:
    device = resolve_device(device)

    def i32(x):
        return torch.tensor(np.asarray(x, np.int32), device=device)

    return DetectorState(
        ewma=_f32(ewma, device), mean=_f32(mean, device), var=_f32(var, device),
        count=i32(count), drifted=torch.tensor(np.asarray(drifted, bool), device=device),
        recovery=i32(recovery),
    )
