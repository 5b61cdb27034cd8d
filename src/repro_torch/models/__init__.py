"""Model zoo of the port (attn + mlp decoders so far).

config.py     ModelConfig / LayerSpec / input shapes (copy of repro.models.config)
layers.py     norms, rotary, SwiGLU, embeddings
attention.py  GQA + qk-norm self-attention; prefill through kernels.ops.mha_flash
blocks.py     block assembly for the (attn, mlp) spec
model.py      Model: prefill / decode over per-layer modules
"""
from .config import INPUT_SHAPES, InputShape, LayerSpec, ModelConfig
from .model import Model

__all__ = ["INPUT_SHAPES", "InputShape", "LayerSpec", "ModelConfig", "Model"]
