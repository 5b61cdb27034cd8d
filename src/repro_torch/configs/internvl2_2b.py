"""internvl2-2b — InternViT + InternLM2 VLM [arXiv:2404.16821].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
The InternViT vision encoder + MLP projector are a STUB per the assignment
carve-out: input_specs() supplies 256 precomputed patch embeddings per image
prepended to the text sequence; this module is the InternLM2 language model.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "internvl2-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="vlm",
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab=92553,
        pattern=(LayerSpec("attn", "mlp"),),
        n_repeats=24,
        n_patches=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="vlm",
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=1024,
        vocab=512,
        pattern=(LayerSpec("attn", "mlp"),),
        n_repeats=2,
        n_patches=16,
        dtype="float32",
    )
