"""olmo-1b — dense with non-parametric LayerNorm [arXiv:2402.00838].

16L d_model=2048 16H (GQA kv=16 = MHA) d_ff=8192 vocab=50304.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "olmo-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab=50304,
        pattern=(LayerSpec("attn", "mlp"),),
        n_repeats=16,
        norm="nonparam_ln",
        tie_embeddings=True,  # OLMo-1B ties input/output embeddings
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="dense",
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        d_ff=1024,
        vocab=512,
        pattern=(LayerSpec("attn", "mlp"),),
        n_repeats=2,
        norm="nonparam_ln",
        tie_embeddings=True,
        dtype="float32",
    )
