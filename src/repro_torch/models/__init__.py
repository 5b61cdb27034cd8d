"""Model zoo of the port: decoders of attention or Mamba mixers with MLP or
MoE ffns, and a prefix of patch embeddings (the encoder-decoder and xLSTM
mixers are still refused).

config.py     ModelConfig / LayerSpec / input shapes (copy of repro.models.config)
layers.py     norms, rotary, SwiGLU, embeddings
attention.py  GQA + qk-norm self-attention; prefill through kernels.ops.mha_flash
blocks.py     block assembly for the attn/mamba mixers and mlp/moe ffns
model.py      Model: prefill (with optional patch embeddings) / decode over per-layer modules
"""
from .config import INPUT_SHAPES, InputShape, LayerSpec, ModelConfig
from .model import Model

__all__ = ["INPUT_SHAPES", "InputShape", "LayerSpec", "ModelConfig", "Model"]
