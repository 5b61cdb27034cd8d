"""deepseek-7b — llama-architecture dense MHA [arXiv:2401.02954].

30L d_model=4096 32H (kv=32 = MHA) d_ff=11008 vocab=102400.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "deepseek-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=11008,
        vocab=102400,
        pattern=(LayerSpec("attn", "mlp"),),
        n_repeats=30,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="dense",
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        d_ff=768,
        vocab=512,
        pattern=(LayerSpec("attn", "mlp"),),
        n_repeats=2,
        dtype="float32",
    )
