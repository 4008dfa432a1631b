"""Model configurations (port of the parts of ``repro.configs`` the
device path uses)."""
from repro_torch.configs.oselm_edge import EDGE_CONFIGS, EdgeConfig

__all__ = ["EDGE_CONFIGS", "EdgeConfig"]
