"""gemma3-1b [dense] — 5:1 local:global attention, 128k/262k vocab.

[hf:google/gemma-3-1b-pt]
26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144 head_dim=256.
Five sliding-window (512) layers per one global layer. (Gemma 3 uses
rope_theta 1M on global layers / 10k local; we keep a single table —
noted in DESIGN.md §8.)
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262144,
    head_dim=256,
    sliding_window=512,
    global_every=6,            # layers 6,12,18,24 global (1-indexed multiple)
)
