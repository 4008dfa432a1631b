"""llama3-405b [dense] — GQA, 128k vocab.

[arXiv:2407.21783] The Llama 3 Herd of Models.
126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
bf16 Adam moments + 8 grad-accumulation microbatches: required to fit
~405B params of optimizer state into 256×16 GB v5e HBM (DESIGN.md §6).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    source="arXiv:2407.21783",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    head_dim=128,
    rope_theta=500000.0,
    moment_dtype="bfloat16",
    num_microbatches=8,
)
