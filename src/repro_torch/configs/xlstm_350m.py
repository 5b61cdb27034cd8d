"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517].

24L d_model=1024 4H (kv=4) d_ff=0 (projection inside blocks) vocab=50304.
Period-8 pattern: sLSTM at in-period index 7, mLSTM elsewhere (the xLSTM[7:1]
ratio used in the paper's language models).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "xlstm-350m"


def _pattern(period: int, slstm_at: int) -> tuple[LayerSpec, ...]:
    return tuple(
        LayerSpec("slstm" if i == slstm_at else "mlstm", "none")
        for i in range(period)
    )


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="ssm",
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        pattern=_pattern(8, 7),
        n_repeats=3,
        xlstm_proj_factor=2.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="ssm",
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=512,
        pattern=_pattern(2, 1),
        n_repeats=1,
        dtype="float32",
    )
