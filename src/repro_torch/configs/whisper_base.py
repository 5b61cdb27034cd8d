"""whisper-base — encoder-decoder audio model [arXiv:2212.04356].

6L (decoder, + 6L encoder) d_model=512 8H d_ff=2048 vocab=51865.
The mel-spectrogram + conv frontend is a STUB per the assignment carve-out:
input_specs() supplies 1500 precomputed frame embeddings (the encoder's
audio context after conv striding).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "whisper-base"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="audio",
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab=51865,
        pattern=(LayerSpec("attn", "mlp"),),
        n_repeats=6,
        n_enc_layers=6,
        enc_ctx=1500,
        norm="ln",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="audio",
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        d_ff=512,
        vocab=512,
        pattern=(LayerSpec("attn", "mlp"),),
        n_repeats=2,
        n_enc_layers=2,
        enc_ctx=64,
        norm="ln",
        dtype="float32",
    )
