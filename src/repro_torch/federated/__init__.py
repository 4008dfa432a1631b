"""The paper's client/server cooperative update, client selection and the
cooperative update as a collective across processes (port of
``repro.federated``)."""
from repro_torch.federated.protocol import (
    CommLog,
    EdgeDevice,
    FederationServer,
    Payload,
    cooperative_round,
)
from repro_torch.federated.mesh_federation import mesh_cooperative_update, mesh_federated_train
from repro_torch.federated.selection import (
    all_clients,
    loss_threshold_selection,
    resource_constrained_selection,
)

__all__ = [
    "CommLog", "EdgeDevice", "FederationServer", "Payload", "cooperative_round",
    "mesh_cooperative_update", "mesh_federated_train",
    "all_clients", "loss_threshold_selection", "resource_constrained_selection",
]
