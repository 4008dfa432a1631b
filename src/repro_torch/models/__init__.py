"""The model zoo's serving path (port of ``repro.models``): configs,
dense, sliding-window and hymba blocks, prefill and decode."""
from repro_torch.models.config import INPUT_SHAPES, ArchConfig, ShapeConfig
from repro_torch.models.model import (
    decode_step,
    forward,
    init_params,
    param_count,
    prefill,
)

__all__ = [
    "INPUT_SHAPES", "ArchConfig", "ShapeConfig",
    "decode_step", "forward", "init_params", "param_count", "prefill",
]
