"""Architecture registry, one module per assigned architecture (a copy of
``repro.configs``), and the paper's own edge-device configuration.

``get_config(name)`` resolves any of the 10 assigned IDs.
"""
from __future__ import annotations

from repro_torch.configs.arctic_480b import CONFIG as arctic_480b
from repro_torch.configs.gemma3_1b import CONFIG as gemma3_1b
from repro_torch.configs.granite_3_2b import CONFIG as granite_3_2b
from repro_torch.configs.granite_34b import CONFIG as granite_34b
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from repro_torch.configs.hymba_1_5b import CONFIG as hymba_1_5b
from repro_torch.configs.llama3_405b import CONFIG as llama3_405b
from repro_torch.configs.llama_3_2_vision_11b import CONFIG as llama_3_2_vision_11b
from repro_torch.configs.oselm_edge import EDGE_CONFIGS, EdgeConfig
from repro_torch.configs.seamless_m4t_medium import CONFIG as seamless_m4t_medium
from repro_torch.configs.xlstm_1_3b import CONFIG as xlstm_1_3b
from repro_torch.models.config import INPUT_SHAPES, ArchConfig, ShapeConfig

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        hymba_1_5b,
        llama3_405b,
        xlstm_1_3b,
        seamless_m4t_medium,
        granite_34b,
        granite_moe_3b_a800m,
        granite_3_2b,
        gemma3_1b,
        arctic_480b,
        llama_3_2_vision_11b,
    )
}


def get_config(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError as e:
        raise ValueError(f"unknown arch {name!r}; have {sorted(ARCHS)}") from e


__all__ = ["ARCHS", "EDGE_CONFIGS", "INPUT_SHAPES", "ArchConfig", "EdgeConfig", "ShapeConfig",
           "get_config"]
