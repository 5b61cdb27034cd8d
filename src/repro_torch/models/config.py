"""Model configuration covering all assigned architecture families.

A model is a repeated ``pattern`` of layers (one period), each layer a
(mixer, ffn) pair:

  mixer ∈ {"attn", "mamba", "mlstm", "slstm"}
  ffn   ∈ {"mlp", "moe", "none"}

plus optional encoder stack (whisper) and stub modality frontends
(audio frames / vision patches arrive as precomputed embeddings).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["LayerSpec", "ModelConfig", "InputShape", "INPUT_SHAPES"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"  # attn | mamba | mlstm | slstm
    ffn: str = "mlp"     # mlp | moe | none

    def __post_init__(self):
        if self.mixer not in ("attn", "mamba", "mlstm", "slstm"):
            raise ValueError(f"unknown mixer {self.mixer}")
        if self.ffn not in ("mlp", "moe", "none"):
            raise ValueError(f"unknown ffn {self.ffn}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str              # dense | moe | hybrid | ssm | audio | vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: tuple[LayerSpec, ...]
    n_repeats: int              # n_layers = len(pattern) * n_repeats

    head_dim: Optional[int] = None   # default d_model // n_heads
    # attention
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # applied for long-context variants
    # norm
    norm: str = "rms"           # rms | ln | nonparam_ln
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # Mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # xLSTM
    xlstm_proj_factor: float = 2.0
    # encoder (whisper) — decoder uses the main pattern
    n_enc_layers: int = 0
    enc_ctx: int = 0            # e.g. 1500 audio frames (stub embeddings)
    # VLM stub frontend
    n_patches: int = 0          # prepended patch embeddings (stub)
    # misc
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        has_moe = any(s.ffn == "moe" for s in self.pattern)
        if has_moe and (self.n_experts < 2 or self.top_k < 1):
            raise ValueError("MoE layers need n_experts>=2, top_k>=1")

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.n_repeats

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.mamba_expand * self.d_model

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def uses_attention(self) -> bool:
        return any(s.mixer == "attn" for s in self.pattern) or self.is_encoder_decoder

    @property
    def subquadratic(self) -> bool:
        """True if every mixer is recurrent/SSM (O(1)-state decode)."""
        return all(s.mixer in ("mamba", "mlstm", "slstm") for s in self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + per-layer), for 6ND."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab * d  # lm head
        for spec in self.pattern * self.n_repeats:
            if spec.mixer == "attn":
                total += d * (self.n_heads * hd)            # q
                total += 2 * d * (self.n_kv_heads * hd)     # k, v
                total += (self.n_heads * hd) * d            # o
            elif spec.mixer == "mamba":
                di = self.d_inner
                total += d * 2 * di                          # in_proj (x, z)
                total += di * self.mamba_d_conv              # depthwise conv
                total += di * (2 * self.mamba_d_state + 1)   # B, C, dt proj-ish
                total += di * d                              # out_proj
            elif spec.mixer in ("mlstm", "slstm"):
                di = int(self.xlstm_proj_factor * d)
                total += d * 2 * di + 3 * di * di // max(self.n_heads, 1) + di * d
            if spec.ffn == "mlp":
                total += 3 * d * self.d_ff                   # swiglu
            elif spec.ffn == "moe":
                total += self.n_experts * 3 * d * self.d_ff
                total += d * self.n_experts                  # router
        if self.is_encoder_decoder:
            for _ in range(self.n_enc_layers):
                total += 4 * d * d + 3 * d * self.d_ff
            # decoder cross-attention
            total += self.n_layers * 4 * d * d
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        dense = self.param_count()
        moe_layers = sum(
            1 for s in self.pattern * self.n_repeats if s.ffn == "moe"
        )
        unused = (self.n_experts - self.top_k) * 3 * self.d_model * self.d_ff
        return dense - moe_layers * unused


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
