"""phi3.5-moe-42b-a6.6b — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab=32064,
        pattern=(LayerSpec("attn", "moe"),),
        n_repeats=32,
        n_experts=16,
        top_k=2,
        norm="ln",  # phi3.5-moe uses LayerNorm
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="moe",
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=384,
        vocab=512,
        pattern=(LayerSpec("attn", "moe"),),
        n_repeats=2,
        n_experts=4,
        top_k=2,
        norm="ln",
        dtype="float32",
    )
