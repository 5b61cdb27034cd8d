"""qwen3-14b — dense with qk-norm and GQA [hf:Qwen/Qwen3-8B family].

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936; head_dim=128.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "qwen3-14b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab=151936,
        pattern=(LayerSpec("attn", "mlp"),),
        n_repeats=40,
        qk_norm=True,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="dense",
        d_model=320,
        n_heads=5,
        n_kv_heads=1,
        head_dim=64,
        d_ff=1024,
        vocab=512,
        pattern=(LayerSpec("attn", "mlp"),),
        n_repeats=2,
        qk_norm=True,
        dtype="float32",
    )
