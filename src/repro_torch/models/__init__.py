"""Model zoo of the port: decoders of attention, Mamba or xLSTM mixers with
MLP, MoE or no ffns, a prefix of patch embeddings, and Whisper's encoder
with the decoder's cross-attention: every arch of the repo.

config.py     ModelConfig / LayerSpec / input shapes (copy of repro.models.config)
layers.py     norms, rotary, SwiGLU, embeddings; plain_products for training
attention.py  GQA + qk-norm self-attention (prefill through kernels.ops.mha_flash;
              training through JAX's plain branches), cross-attention and the
              encoder's K/V
mamba.py      selective SSM mixer (prefill through kernels.ops.mamba_scan;
              training through a plain associative scan)
moe.py        mixture-of-experts ffn
xlstm.py      mLSTM and sLSTM mixers
blocks.py     block assembly for every mixer and ffn, and the cross path
model.py      Model: encoder, prefill (with optional patch or frame embeddings),
              decode, and forward_train / loss (training) over per-layer modules
sharding.py   partition specs of parameters, caches and batches (JAX's rules)
"""
from .config import INPUT_SHAPES, InputShape, LayerSpec, ModelConfig
from .model import Model
from .xlstm import MLstmState, SLstmState

__all__ = ["INPUT_SHAPES", "InputShape", "LayerSpec", "ModelConfig", "Model", "MLstmState",
           "SLstmState"]
