"""Architecture registry of the port: one module per assigned arch.

Counterpart of ``repro.configs``: ``get_config(arch_id)`` /
``get_smoke_config(arch_id)`` / ``ARCH_IDS``.  ``long_context_variant(cfg)``
returns the explicitly-flagged sliding-window variant used for long_500k on
full-attention archs; sub-quadratic archs are returned unchanged.
``supports_shape`` encodes the skip table (whisper × long_500k is the only
skip).  All ten configs are data here; ``models.Model`` still refuses the
encoder-decoder (whisper-base) and xLSTM (xlstm-350m), naming ROADMAP.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

from . import (
    dbrx_132b,
    deepseek_7b,
    internvl2_2b,
    jamba_52b,
    olmo_1b,
    phi35_moe,
    qwen3_0_6b,
    qwen3_14b,
    whisper_base,
    xlstm_350m,
)

_MODULES = {
    m.ARCH_ID: m
    for m in (
        dbrx_132b,
        jamba_52b,
        olmo_1b,
        phi35_moe,
        xlstm_350m,
        whisper_base,
        qwen3_0_6b,
        deepseek_7b,
        qwen3_14b,
        internvl2_2b,
    )
}

ARCH_IDS: tuple[str, ...] = tuple(_MODULES)

LONG_CONTEXT_WINDOW = 4096


def get_config(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].smoke_config()


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """Sliding-window variant for long_500k on attention-bearing archs."""
    if cfg.subquadratic:
        return cfg
    return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)


def supports_shape(arch_id: str, shape: str | InputShape) -> bool:
    """Skip table: whisper-base skips long_500k (full-attention enc-dec, no
    windowed variant in family).  Everything else runs all four shapes."""
    name = shape if isinstance(shape, str) else shape.name
    if arch_id == "whisper-base" and name == "long_500k":
        return False
    return True


def shape_config(arch_id: str, shape_name: str) -> Optional[ModelConfig]:
    """Config to use for a given (arch, input shape), or None if skipped."""
    if not supports_shape(arch_id, shape_name):
        return None
    cfg = get_config(arch_id)
    if shape_name == "long_500k":
        cfg = long_context_variant(cfg)
    return cfg


__all__ = [
    "ARCH_IDS",
    "LONG_CONTEXT_WINDOW",
    "get_config",
    "get_smoke_config",
    "long_context_variant",
    "supports_shape",
    "shape_config",
    "INPUT_SHAPES",
]
