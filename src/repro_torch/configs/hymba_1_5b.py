"""hymba-1.5b [hybrid] — parallel attention + mamba heads.

[arXiv:2411.13676] Hymba: A Hybrid-head Architecture for Small LMs.
32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001 ssm_state=16.
Hymba uses full (global) attention in only 3 layers — first, middle,
last — and sliding-window attention elsewhere; the mamba head runs in
parallel with the attention head in every layer and the outputs are
averaged. (The depthwise conv inside the mamba branch and the learnable
meta-tokens are omitted — DESIGN.md §8.)
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,               # 1600 / 25
    ssm_state=16,
    mamba_expand=1,
    sliding_window=1024,
    global_layers=(0, 15, 31),  # first / middle / last
    detector_hidden=64,
)
