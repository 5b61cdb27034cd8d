"""Decoder-block assembly: (norm → mixer → residual) → (norm → ffn → residual).

Counterpart of ``repro.models.blocks`` for the (attn, mlp) layer spec.
Caches are per-layer dicts ``{"kv": KVCache}``.  Other mixers and ffns
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import attention as attn
from .config import LayerSpec, ModelConfig
from .layers import MLP, Norm, apply_norm, init_norm, mlp

__all__ = ["Block", "init_block", "init_block_cache", "block_prefill",
           "block_decode"]

_TODO = {
    "mamba": "ROADMAP 'Modules to port': Mamba (jamba-v0.1-52b)",
    "mlstm": "ROADMAP 'Modules to port': xLSTM (xlstm-350m)",
    "slstm": "ROADMAP 'Modules to port': xLSTM (xlstm-350m)",
    "moe": "ROADMAP 'Modules to port': MoE (phi3.5-moe, dbrx-132b)",
}


def _check_spec(spec: LayerSpec) -> None:
    for kind in (spec.mixer, spec.ffn):
        if kind in _TODO:
            raise NotImplementedError(f"{kind} is not ported yet: {_TODO[kind]}")


class Block(nn.Module):
    """norm1, mixer (Attention), and for ffn != none: norm2, ffn (MLP)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, dtype, device):
        super().__init__()
        _check_spec(spec)
        self.spec = spec
        self.norm1 = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.mixer = attn.Attention(cfg, dtype, device)
        if spec.ffn != "none":
            self.norm2 = Norm(cfg.norm, cfg.d_model, dtype, device)
            self.ffn = MLP(cfg.d_model, cfg.d_ff, dtype, device)


def init_block(block: Block, gen: torch.Generator) -> None:
    init_norm(block.norm1)
    block.mixer.init(gen)
    if block.spec.ffn != "none":
        init_norm(block.norm2)
        block.ffn.init(gen)


def init_block_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device):
    """Zero-initialized per-layer cache for decode."""
    _check_spec(spec)
    kvshape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"kv": attn.KVCache(
        k=torch.zeros(kvshape, dtype=dtype, device=device),
        v=torch.zeros(kvshape, dtype=dtype, device=device),
    )}


def _ffn_apply(p: Block, cfg, spec: LayerSpec, x):
    if spec.ffn == "none":
        return x
    h = apply_norm(p.norm2, x, cfg.norm)
    return x + mlp(p.ffn, h)


def block_prefill(p: Block, cfg, spec: LayerSpec, x, cache,
                  window: Optional[int] = None):
    """Runs the block over the prompt; writes the prompt's K/V into the
    cache buffer at offset 0 (in place)."""
    h = apply_norm(p.norm1, x, cfg.norm)
    y, kv = attn.attention_prefill(p.mixer, cfg, h, window)
    x = x + y
    buf = cache["kv"]
    s = kv.k.shape[1]
    buf.k[:, :s] = kv.k.to(buf.k.dtype)
    buf.v[:, :s] = kv.v.to(buf.v.dtype)
    return _ffn_apply(p, cfg, spec, x), cache


def block_decode(p: Block, cfg, spec: LayerSpec, x, cache, cache_len,
                 window: Optional[int] = None):
    h = apply_norm(p.norm1, x, cfg.norm)
    y, _ = attn.attention_decode(p.mixer, cfg, h, cache["kv"], cache_len, window)
    x = x + y
    return _ffn_apply(p, cfg, spec, x), cache
