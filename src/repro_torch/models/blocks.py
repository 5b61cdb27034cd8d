"""Decoder-block assembly: (norm → mixer → residual) → (norm → ffn → residual).

Counterpart of ``repro.models.blocks`` for the attn and mamba mixers and
the mlp and moe ffns.  Caches are per-layer dicts: ``{"kv": KVCache}`` for
attention, ``{"ssm": MambaState}`` for Mamba; prefill and decode write
into their tensors in place, never replacing them.  The MoE aux loss is
dropped in serving.  xLSTM mixers raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import attention as attn
from . import mamba as mb
from .config import LayerSpec, ModelConfig
from .layers import MLP, Norm, apply_norm, init_norm, mlp
from .moe import MoE, moe_ffn

__all__ = ["Block", "init_block", "init_block_cache", "block_prefill",
           "block_decode"]

_TODO = {
    "mlstm": "ROADMAP 'Modules to port': xLSTM (xlstm-350m)",
    "slstm": "ROADMAP 'Modules to port': xLSTM (xlstm-350m)",
}


def _check_spec(spec: LayerSpec) -> None:
    for kind in (spec.mixer, spec.ffn):
        if kind in _TODO:
            raise NotImplementedError(f"{kind} is not ported yet: {_TODO[kind]}")


class Block(nn.Module):
    """norm1, mixer (Attention or Mamba), and for ffn != none: norm2, ffn
    (MLP or MoE)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, dtype, device):
        super().__init__()
        _check_spec(spec)
        self.spec = spec
        self.norm1 = Norm(cfg.norm, cfg.d_model, dtype, device)
        if spec.mixer == "attn":
            self.mixer = attn.Attention(cfg, dtype, device)
        else:
            self.mixer = mb.Mamba(cfg, dtype, device)
        if spec.ffn != "none":
            self.norm2 = Norm(cfg.norm, cfg.d_model, dtype, device)
            if spec.ffn == "mlp":
                self.ffn = MLP(cfg.d_model, cfg.d_ff, dtype, device)
            else:
                self.ffn = MoE(cfg, dtype, device)


def init_block(block: Block, gen: torch.Generator) -> None:
    init_norm(block.norm1)
    block.mixer.init(gen)
    if block.spec.ffn != "none":
        init_norm(block.norm2)
        block.ffn.init(gen)


def init_block_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device):
    """Zero-initialized per-layer cache for decode.  The Mamba conv buffer
    holds ``dtype``, as a prefill leaves it (JAX's tail of the prompt's
    activations)."""
    _check_spec(spec)
    if spec.mixer == "mamba":
        return {"ssm": mb.init_mamba_state(cfg, batch, device, dtype)}
    kvshape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"kv": attn.KVCache(
        k=torch.zeros(kvshape, dtype=dtype, device=device),
        v=torch.zeros(kvshape, dtype=dtype, device=device),
    )}


def _ffn_apply(p: Block, cfg, spec: LayerSpec, x):
    """-> (x, MoE aux loss or 0.0)."""
    if spec.ffn == "none":
        return x, 0.0
    h = apply_norm(p.norm2, x, cfg.norm)
    if spec.ffn == "mlp":
        return x + mlp(p.ffn, h), 0.0
    y, aux = moe_ffn(p.ffn, cfg, h)
    return x + y, aux


def block_prefill(p: Block, cfg, spec: LayerSpec, x, cache,
                  window: Optional[int] = None):
    """Runs the block over the prompt; writes the prompt's K/V into the
    cache buffer at offset 0, or the final Mamba state into the cache's
    state tensors (in place)."""
    h = apply_norm(p.norm1, x, cfg.norm)
    if spec.mixer == "attn":
        y, kv = attn.attention_prefill(p.mixer, cfg, h, window)
        buf = cache["kv"]
        s = kv.k.shape[1]
        buf.k[:, :s] = kv.k.to(buf.k.dtype)
        buf.v[:, :s] = kv.v.to(buf.v.dtype)
    else:
        y, final = mb.mamba_prefill(p.mixer, cfg, h)
        for buf, value in zip(cache["ssm"], final):
            buf.copy_(value)
    x, _ = _ffn_apply(p, cfg, spec, x + y)
    return x, cache


def block_decode(p: Block, cfg, spec: LayerSpec, x, cache, cache_len,
                 window: Optional[int] = None):
    h = apply_norm(p.norm1, x, cfg.norm)
    if spec.mixer == "attn":
        y, _ = attn.attention_decode(p.mixer, cfg, h, cache["kv"], cache_len, window)
    else:
        y, _ = mb.mamba_decode(p.mixer, cfg, h, cache["ssm"])
    x, _ = _ffn_apply(p, cfg, spec, x + y)
    return x, cache
