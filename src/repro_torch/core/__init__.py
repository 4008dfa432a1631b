"""Core ELM / OS-ELM / E²LM algebra on torch tensors (port of ``repro.core``)."""
from repro_torch.core.activations import get_activation
from repro_torch.core.autoencoder import ae_score
from repro_torch.core.e2lm import UV, from_uv, to_uv
from repro_torch.core.elm import SLFNParams, hidden, init_slfn, invert_u, solve_beta
from repro_torch.core.oselm import (
    OSELMState,
    init_oselm,
    oselm_loss,
    oselm_predict,
    oselm_step_k1,
)

__all__ = [
    "get_activation", "ae_score", "UV", "from_uv", "to_uv",
    "SLFNParams", "hidden", "init_slfn", "invert_u", "solve_beta",
    "OSELMState", "init_oselm", "oselm_loss", "oselm_predict", "oselm_step_k1",
]
