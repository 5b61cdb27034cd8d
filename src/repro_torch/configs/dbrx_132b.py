"""dbrx-132b — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "dbrx-132b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab=100352,
        pattern=(LayerSpec("attn", "moe"),),
        n_repeats=40,
        n_experts=16,
        top_k=4,
        norm="ln",  # dbrx uses LayerNorm
        rope_theta=500_000.0,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts."""
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="moe",
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        d_ff=448,
        vocab=512,
        pattern=(LayerSpec("attn", "moe"),),
        n_repeats=2,
        n_experts=4,
        top_k=2,
        norm="ln",
        dtype="float32",
    )
