"""OS-ELM autoencoder for semi-supervised anomaly detection (paper §3.4);
port of ``repro.core.autoencoder``.

The autoencoder reconstructs its input (n == m) through a bottleneck
(Ñ < n); the reconstruction MSE is the anomaly score, and a sample whose
score is above a threshold can be rejected before training (§3.4).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.elm import init_slfn
from repro_torch.core.oselm import (
    OSELMState,
    init_oselm,
    oselm_loss,
    oselm_step_k1,
    oselm_train_sequential,
)


def init_autoencoder(
    generator: torch.Generator,
    n_features: int,
    n_hidden: int,
    x0,
    *,
    activation: str = "sigmoid",
    ridge: float = 0.0,
    forget: float = 1.0,
    device: str | torch.device | None = None,
) -> OSELMState:
    """Draw the SLFN from ``generator`` (Ñ < n enforced) and run the
    Eq. 13 init with ``x0`` (k, n; an array or a tensor) as input and
    target, on ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    if n_hidden >= n_features:
        raise ValueError(f"autoencoder needs a bottleneck: Ñ={n_hidden} >= n={n_features}")
    params = init_slfn(generator, n_features, n_hidden, device=device)
    if isinstance(x0, torch.Tensor):
        x = x0.to(device=device, dtype=torch.float32)
    else:
        x = torch.as_tensor(np.asarray(x0, np.float32), device=device)
    return init_oselm(params, x, x, activation=activation, ridge=ridge, forget=forget)


def ae_score(state: OSELMState, x: torch.Tensor) -> torch.Tensor:
    """Reconstruction MSE per sample; high = anomalous."""
    return oselm_loss(state, x, x)


def ae_train_step(state: OSELMState, x: torch.Tensor) -> OSELMState:
    """One k=1 autoencoder update (t = x)."""
    return oselm_step_k1(state, x, x)


def ae_train_stream(state: OSELMState, xs: torch.Tensor) -> OSELMState:
    """The k=1 update over a stream of samples (T, n)."""
    return oselm_train_sequential(state, xs, xs)


def ae_train_step_guarded(
    state: OSELMState, x: torch.Tensor, reject_threshold: torch.Tensor | float
) -> tuple[OSELMState, torch.Tensor]:
    """Train only if the sample is not anomalous under the current model
    (§3.4 rejection rule): ``(state, accepted)``, with ``accepted`` a
    boolean tensor on the state's device (no read back to the host)."""
    accept = ae_score(state, x[None, :])[0] <= reject_threshold
    new = oselm_step_k1(state, x, x)
    return state.replace(beta=torch.where(accept, new.beta, state.beta),
                         p=torch.where(accept, new.p, state.p)), accept


@dataclasses.dataclass(frozen=True)
class DetectorBank:
    """Several on-device learning instances, one per normal pattern (ref
    [18]); the bank's anomaly score is the minimum over its instances.
    Instances may be drawn from different bases, and the port's stacked
    state shares one basis, so the bank keeps one state per instance."""

    states: tuple[OSELMState, ...]

    @property
    def n_instances(self) -> int:
        return len(self.states)


def make_bank(states: list[OSELMState]) -> DetectorBank:
    return DetectorBank(states=tuple(states))


def bank_score(bank: DetectorBank, x: torch.Tensor) -> torch.Tensor:
    """Minimum over instances of the reconstruction loss: a sample is
    normal if any specialised instance reconstructs it."""
    return torch.stack([ae_score(s, x) for s in bank.states]).min(0).values


def bank_train_instance(bank: DetectorBank, idx: int, x: torch.Tensor) -> DetectorBank:
    """One k=1 step of instance ``idx`` on a sample."""
    states = list(bank.states)
    states[idx] = ae_train_step(states[idx], x)
    return DetectorBank(states=tuple(states))
