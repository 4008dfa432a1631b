"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks.

[arXiv:2405.04517] xLSTM: Extended Long Short-Term Memory.
48L d_model=2048 4H d_ff=0 vocab=50304. d_ff=0: xLSTM blocks carry
their own projections and have no separate FFN. One sLSTM block every
8 layers (the paper's 7:1 mLSTM:sLSTM ratio), the rest are mLSTM
(matrix-memory) blocks with chunk-parallel training (DESIGN.md §4).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    source="arXiv:2405.04517",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=512,              # 2048 / 4
    slstm_every=8,
)
