"""granite-3-2b [dense] — GQA.

[hf:ibm-granite/granite-3.0-2b-base]
40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.

``long_500k`` runs on the beyond-paper sliding-window serving variant
(window 4096) — see SWA_VARIANT below and DESIGN.md §5.
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    source="hf:ibm-granite/granite-3.0-2b-base",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
    head_dim=64,
)

# serving-only variant for the long_500k dense carve-out
SWA_VARIANT = dataclasses.replace(CONFIG, sliding_window=4096)
