"""arctic-480b [moe] — 128 experts top-2 + dense residual.

[hf:Snowflake/snowflake-arctic-base]
35L d_model=7168 56H (GQA kv=8) d_ff=4864, MoE 128 experts top-2 with a
dense FFN residual computed in parallel with the MoE branch (Arctic's
dense-MoE hybrid architecture).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    head_dim=128,
    n_experts=128,
    experts_per_token=2,
    dense_residual=True,
    tokens_per_group=1024,
    moment_dtype="bfloat16",
    num_microbatches=4,     # §Perf 2.1: FSDP weight gathers repeat per microbatch
)
