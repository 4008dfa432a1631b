"""Core ELM / OS-ELM / E²LM algebra on torch tensors (port of ``repro.core``)."""
from repro_torch.core.activations import get_activation, register_activation
from repro_torch.core.autoencoder import (
    DetectorBank,
    ae_score,
    ae_train_step,
    ae_train_step_guarded,
    ae_train_stream,
    bank_score,
    bank_train_instance,
    init_autoencoder,
    make_bank,
)
from repro_torch.core.e2lm import (
    UV,
    cooperative_update,
    from_uv,
    to_uv,
    uv_add,
    uv_replace,
    uv_sub,
    uv_sum,
)
from repro_torch.core.elm import (
    ELMModel,
    SLFNParams,
    hidden,
    init_slfn,
    invert_u,
    predict_elm,
    solve_beta,
    train_elm,
)
from repro_torch.core.oselm import (
    OSELMState,
    init_oselm,
    oselm_loss,
    oselm_predict,
    oselm_step,
    oselm_step_k1,
    oselm_train_sequential,
)

__all__ = [
    "get_activation", "register_activation",
    "DetectorBank", "ae_score", "ae_train_step", "ae_train_step_guarded", "ae_train_stream",
    "bank_score", "bank_train_instance", "init_autoencoder", "make_bank",
    "UV", "cooperative_update", "from_uv", "to_uv", "uv_add", "uv_replace", "uv_sub", "uv_sum",
    "ELMModel", "SLFNParams", "hidden", "init_slfn", "invert_u", "predict_elm", "solve_beta",
    "train_elm",
    "OSELMState", "init_oselm", "oselm_loss", "oselm_predict", "oselm_step", "oselm_step_k1",
    "oselm_train_sequential",
]
