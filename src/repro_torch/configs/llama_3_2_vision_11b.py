"""llama-3.2-vision-11b [vlm] — cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision]
40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256. Every 5th
layer is a cross-attention block (tanh-gated) consuming projected image
patch embeddings. The ViT vision encoder is a STUB — input_specs()
provides precomputed patch embeddings (B, 1601, 1280) (DESIGN.md §5).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    head_dim=128,
    rope_theta=500000.0,
    cross_attn_every=5,
    frontend="vision",
    n_frontend_tokens=1601,    # 1 CLS + 1600 patches
    d_frontend=1280,
    num_microbatches=2,
)
