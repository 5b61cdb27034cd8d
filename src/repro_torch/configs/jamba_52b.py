"""jamba-v0.1-52b — Mamba+attention 1:7 interleave with MoE [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Period-8 pattern: attention at in-period index 4, mamba elsewhere;
MoE on every other layer (odd in-period indices), MLP otherwise.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "jamba-v0.1-52b"


def _pattern(period: int, attn_at: int) -> tuple[LayerSpec, ...]:
    specs = []
    for i in range(period):
        mixer = "attn" if i == attn_at else "mamba"
        ffn = "moe" if i % 2 == 1 else "mlp"
        specs.append(LayerSpec(mixer, ffn))
    return tuple(specs)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="hybrid",
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=65536,
        pattern=_pattern(8, 4),
        n_repeats=4,
        n_experts=16,
        top_k=2,
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_expand=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="hybrid",
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=512,
        vocab=512,
        pattern=_pattern(2, 1),  # one mamba + one attn layer
        n_repeats=1,
        n_experts=4,
        top_k=2,
        dtype="float32",
    )
