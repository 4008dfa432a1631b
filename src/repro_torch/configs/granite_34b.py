"""granite-34b [dense] — llama-arch code model, MQA.

[arXiv:2405.04324] Granite Code Models.
88L d_model=6144 48H (kv=1 — multi-query attention) d_ff=24576
vocab=49152.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    source="arXiv:2405.04324",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    ffn_type="gelu_mlp",       # GPT-BigCode MLP (no gate) — matches the 34B size
    moment_dtype="bfloat16",
    num_microbatches=4,
)
