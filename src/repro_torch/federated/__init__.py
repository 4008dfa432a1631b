"""The paper's client/server cooperative update and client selection
(port of ``repro.federated``'s protocol and selection)."""
from repro_torch.federated.protocol import (
    CommLog,
    EdgeDevice,
    FederationServer,
    Payload,
    cooperative_round,
)
from repro_torch.federated.selection import (
    all_clients,
    loss_threshold_selection,
    resource_constrained_selection,
)

__all__ = [
    "CommLog", "EdgeDevice", "FederationServer", "Payload", "cooperative_round",
    "all_clients", "loss_threshold_selection", "resource_constrained_selection",
]
