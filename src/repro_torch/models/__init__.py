"""The model zoo (port of ``repro.models``): configs, every block kind
(dense, sliding-window, hymba, xLSTM, MoE and arctic, encoder-decoder and
VLM cross attention), the encoder and the frontend stubs, prefill and
decode, and the training loss."""
from repro_torch.models.config import INPUT_SHAPES, ArchConfig, ShapeConfig
from repro_torch.models.model import (
    active_param_count,
    cache_shape_structs,
    decode_step,
    encoder_forward,
    forward,
    init_params,
    input_specs,
    lm_loss,
    param_count,
    prefill,
)
from repro_torch.models.moe import moe_ffn

__all__ = [
    "INPUT_SHAPES", "ArchConfig", "ShapeConfig",
    "active_param_count", "cache_shape_structs", "decode_step", "encoder_forward", "forward",
    "init_params", "input_specs", "lm_loss", "moe_ffn", "param_count", "prefill",
]
