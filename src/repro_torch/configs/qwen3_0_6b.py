"""qwen3-0.6b — dense with qk-norm and GQA [hf:Qwen/Qwen3-8B family].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936; head_dim=128
(Qwen3 decouples head_dim from d_model/n_heads).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "qwen3-0.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab=151936,
        pattern=(LayerSpec("attn", "mlp"),),
        n_repeats=28,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="dense",
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab=512,
        pattern=(LayerSpec("attn", "mlp"),),
        n_repeats=2,
        qk_norm=True,
        tie_embeddings=True,
        dtype="float32",
    )
