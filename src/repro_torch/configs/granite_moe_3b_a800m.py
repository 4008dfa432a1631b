"""granite-moe-3b-a800m [moe] — fine-grained experts, top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base] (family card).
32L d_model=1536 24H (GQA kv=8) d_ff=512 per expert, MoE 40 experts
top-8. NOTE: the assignment text says "MoE 40e top-8" while its
bracket comment says 32 experts — we follow the explicit 40e spec.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,                  # per-expert FFN width (fine-grained experts)
    vocab=49155,
    head_dim=64,
    n_experts=40,
    experts_per_token=8,
    tokens_per_group=128,   # §Perf 3.2: dispatch cost ∝ ts (cap ∝ ts)
)
