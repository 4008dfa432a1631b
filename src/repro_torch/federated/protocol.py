"""The paper's client/server cooperative-update protocol (§4.2, Figs. 4/5);
port of ``repro.federated.protocol``.

Edge devices train OS-ELM autoencoders one sample at a time. When a
cooperative update is requested they (1) compute (U, V) by Eq. 15,
(2) upload it to the server, (3) download the intermediate results of the
peers they ask for, (4) add them (Eq. 8) and (5) recover (P, β) (Eq. 6).
The server only exchanges payloads; the merge runs on the device.

A payload crosses the network as host arrays: ``Payload.from_uv`` copies
(U, V) from the device to the host and ``Payload.to_uv`` back onto a
device. Its cost is Ñ(Ñ+m) floats an upload, whatever the data trained:
the paper's communication claim against R-round FedAvg.

On the card an ``EdgeDevice`` boots through the core kernels (Eq. 13's
HᵀH and Hᵀt: ``hidden_proj`` and ``matmul_atb``) and trains its stream
through the fused k=1 ingest (``fleet_ingest`` with one device).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import (
    UV,
    OSELMState,
    ae_score,
    ae_train_stream,
    from_uv,
    init_autoencoder,
    to_uv,
    uv_add,
)

__all__ = ["CommLog", "EdgeDevice", "FederationServer", "Payload", "cooperative_round"]


@dataclasses.dataclass
class Payload:
    """Serialized (U, V): what crosses the network."""

    device_id: str
    u: np.ndarray
    v: np.ndarray
    version: int = 0

    @property
    def nbytes(self) -> int:
        return self.u.nbytes + self.v.nbytes

    def to_uv(self, device: str | torch.device | None = None) -> UV:
        """(U, V) on ``device`` (the card unless ``device="cpu"``)."""
        device = resolve_device(device)
        return UV(u=torch.from_numpy(self.u).to(device), v=torch.from_numpy(self.v).to(device))

    @staticmethod
    def from_uv(device_id: str, uv: UV, version: int = 0) -> "Payload":
        return Payload(device_id, uv.u.detach().cpu().numpy(), uv.v.detach().cpu().numpy(),
                       version)


@dataclasses.dataclass
class CommLog:
    uploads: int = 0
    downloads: int = 0
    bytes_up: int = 0
    bytes_down: int = 0

    def up(self, payload: Payload) -> None:
        self.uploads += 1
        self.bytes_up += payload.nbytes

    def down(self, payload: Payload) -> None:
        self.downloads += 1
        self.bytes_down += payload.nbytes


class FederationServer:
    """Holds each device's latest intermediate results (Fig. 4)."""

    def __init__(self) -> None:
        self.store: dict[str, Payload] = {}
        self.log = CommLog()

    def upload(self, payload: Payload) -> None:
        self.log.up(payload)
        self.store[payload.device_id] = payload

    def download(self, device_id: str, exclude: str | None = None) -> Payload:
        p = self.store[device_id]
        self.log.down(p)
        return p

    def peers_of(self, device_id: str) -> list[str]:
        return [d for d in self.store if d != device_id]


class EdgeDevice:
    """One edge device: an OS-ELM autoencoder and the cooperative protocol.
    The basis is drawn from ``generator`` (devices that are to merge share
    one seed, so one basis), and the state lives on ``device``, the card
    unless ``device="cpu"``."""

    def __init__(
        self,
        device_id: str,
        generator: torch.Generator,
        n_features: int,
        n_hidden: int,
        x_init,
        *,
        activation: str = "sigmoid",
        ridge: float = 0.0,
        device: str | torch.device | None = None,
    ) -> None:
        self.device_id = device_id
        self.state: OSELMState = init_autoencoder(
            generator, n_features, n_hidden, x_init, activation=activation, ridge=ridge,
            device=device,
        )
        self.version = 0

    @property
    def device(self) -> torch.device:
        return self.state.device

    def _on(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32).contiguous()
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # --- local life cycle -------------------------------------------------
    def train(self, xs) -> None:
        """Sequential k=1 training on the device's own stream (T, n)."""
        self.state = ae_train_stream(self.state, self._on(xs))

    def score(self, x) -> np.ndarray:
        return ae_score(self.state, self._on(x)).cpu().numpy()

    # --- cooperative update (§4.2) ----------------------------------------
    def share(self, server: FederationServer) -> None:
        """Steps 1–2: compute (U, V) by Eq. 15 and upload it."""
        self.version += 1
        server.upload(Payload.from_uv(self.device_id, to_uv(self.state), self.version))

    def merge_from(self, server: FederationServer, peer_ids: Iterable[str]) -> None:
        """Steps 3–5: download the peers asked for, add them (Eq. 8) and
        recover (P, β) (Eq. 6)."""
        merged = to_uv(self.state)
        for pid in peer_ids:
            merged = uv_add(merged, server.download(pid, exclude=self.device_id).to_uv(self.device))
        self.state = from_uv(self.state, merged)


def cooperative_round(devices: list[EdgeDevice], server: FederationServer, *, select=None) -> None:
    """One one-shot cooperative model update across a device set.
    ``select(device_ids) -> ids`` is the client-selection hook (refs
    [19][20]); by default every device merges."""
    for d in devices:
        d.share(server)
    ids = [d.device_id for d in devices]
    chosen = list(select(ids)) if select is not None else ids
    for d in devices:
        if d.device_id in chosen:
            d.merge_from(server, [i for i in chosen if i != d.device_id])
