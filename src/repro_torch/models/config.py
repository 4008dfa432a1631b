"""Architecture config schema for the assigned model pool; a copy of
``repro.models.config`` (plain data, no framework in it).

One frozen dataclass covers all six families (dense / moe / ssm /
hybrid / audio / vlm); per-arch modules in ``repro_torch.configs`` fill
it in with the exact published numbers and cite their source.

``layer_pattern()`` returns the per-layer block kind; the model keeps
the layers' weights stacked per kind, in pattern order
(``repro_torch.models.model``).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]

# Block kinds (see repro.models.blocks):
#   dense      full-attention + SwiGLU
#   swa        sliding-window attention + SwiGLU
#   moe        full-attention + top-k MoE FFN
#   arctic     full-attention + (dense FFN ∥ top-k MoE) residual
#   hymba      parallel (attention ∥ mamba) heads + SwiGLU; swa variant
#   mlstm      xLSTM matrix-memory block
#   slstm      xLSTM scalar-memory block (sequential scan)
#   enc        bidirectional attention + FFN (encoder)
#   dec        causal attention + cross-attention + FFN (decoder)
#   xattn      cross-attention + SwiGLU (VLM image-fusion layer)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    source: str                       # paper / model-card citation
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None       # default d_model // n_heads

    # --- attention pattern ------------------------------------------------
    sliding_window: int = 0           # 0 = full attention everywhere
    global_every: int = 0             # gemma3: one global layer per N
    global_layers: tuple[int, ...] = ()  # hymba: explicit global layer ids

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    dense_residual: bool = False      # arctic: dense FFN in parallel with MoE
    tokens_per_group: int = 1024
    capacity_factor: float = 1.25
    moe_dispatch: str = "einsum"      # "einsum" (GSPMD-friendly) | "scatter" (refuted — see EXPERIMENTS §Perf)

    # --- SSM / recurrent ----------------------------------------------------
    ssm_state: int = 0
    mamba_expand: int = 1             # d_inner = expand * d_model
    slstm_every: int = 0              # xlstm: sLSTM block every N layers

    # --- encoder-decoder / multimodal ---------------------------------------
    encoder_layers: int = 0           # seamless: bidirectional encoder depth
    cross_attn_every: int = 0         # vlm: cross-attn block every N layers
    frontend: str | None = None       # "audio" | "vision" (STUB — DESIGN.md §5)
    n_frontend_tokens: int = 0        # frames / image patches
    d_frontend: int = 0               # frontend embedding width

    # --- numerics / training knobs -------------------------------------------
    ffn_type: str = "swiglu"          # "swiglu" | "gelu_mlp" (GPT-BigCode style)
    kv_cache_dtype: str = "param"     # "param" | "float8_e4m3fn" (decode-memory opt)
    rope_theta: float = 10000.0
    param_dtype: str = "bfloat16"
    moment_dtype: str = "float32"     # bf16 for the ≥100B archs (HBM fit)
    num_microbatches: int = 1         # grad-accumulation chunks in train_step
    norm_eps: float = 1e-5

    # --- detector (the paper's technique) ------------------------------------
    detector_hidden: int = 64         # OS-ELM autoencoder Ñ for the feature tap

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, "GQA needs H % KV == 0"

    # ------------------------------------------------------------------ utils
    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def layer_pattern(self) -> tuple[str, ...]:
        """Per-layer (decoder) block kinds."""
        L = self.n_layers
        if self.family == "ssm":
            return tuple(
                "slstm" if self.slstm_every and i % self.slstm_every == 0 else "mlstm"
                for i in range(L)
            )
        if self.family == "hybrid":
            return tuple(
                "hymba" if i in self.global_layers else "hymba_swa" for i in range(L)
            )
        if self.family == "moe":
            return tuple(("arctic" if self.dense_residual else "moe") for _ in range(L))
        if self.family == "audio":
            return tuple("dec" for _ in range(L))
        if self.family == "vlm":
            k = self.cross_attn_every
            return tuple(
                "xattn" if k and (i + 1) % k == 0 else "dense" for i in range(L)
            )
        # dense
        if self.sliding_window and self.global_every:
            # gemma3: (global_every - 1) local then 1 global, repeating
            return tuple(
                "dense" if (i + 1) % self.global_every == 0 else "swa"
                for i in range(L)
            )
        if self.sliding_window:
            return tuple("swa" for _ in range(L))
        return tuple("dense" for _ in range(L))

    def encoder_pattern(self) -> tuple[str, ...]:
        return tuple("enc" for _ in range(self.encoder_layers))

    def supports_long_decode(self) -> bool:
        """Sub-quadratic decode feasibility (DESIGN.md long_500k table)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return bool(self.sliding_window)

    def supports_decode(self) -> bool:
        return True  # all assigned archs have a decoder

    def reduced(self, *, n_layers: int = 2, d_model: int = 256) -> "ArchConfig":
        """Smoke-test variant: same family/kind structure, tiny dims."""
        d_model = min(d_model, 512)
        n_heads = max(2, min(4, self.n_heads))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=2 * d_model if self.d_ff else 0,
            vocab=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.experts_per_token else 0,
            tokens_per_group=64,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            global_every=min(self.global_every, 2) if self.global_every else 0,
            global_layers=(0,) if self.global_layers else (),
            slstm_every=2 if self.slstm_every else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            n_frontend_tokens=16 if self.n_frontend_tokens else 0,
            d_frontend=64 if self.d_frontend else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            num_microbatches=1,
            detector_hidden=16,
            param_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


INPUT_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
