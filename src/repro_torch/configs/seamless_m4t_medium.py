"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.

[arXiv:2308.11596] SeamlessM4T: Massively Multilingual & Multimodal MT.
12L d_model=1024 16H d_ff=4096 vocab=256206. Transformer backbone only:
the mel-spectrogram + conv feature extractor is a STUB — input_specs()
provides precomputed speech-frame embeddings (B, 1024 frames, 1024)
consumed by a 12-layer bidirectional encoder; the 12-layer text decoder
cross-attends to the encoder output (DESIGN.md §5, the allowed
carve-out).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596",
    n_layers=12,               # decoder depth
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    head_dim=64,
    encoder_layers=12,
    frontend="audio",
    n_frontend_tokens=1024,    # speech frames after the (stubbed) conv stack
    d_frontend=1024,
)
