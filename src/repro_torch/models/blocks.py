"""Decoder-block assembly: (norm → mixer → residual) → [cross-attn] →
(norm → ffn → residual).

Counterpart of ``repro.models.blocks`` for every mixer (attn, mamba,
mlstm, slstm) and ffn (mlp, moe, none), and the Whisper decoder's
cross-attention.  Caches are per-layer dicts: ``{"kv": KVCache}`` for
attention, ``{"ssm": MambaState}`` for Mamba, ``{"xl": MLstmState}`` or
``{"xl": SLstmState}`` for xLSTM, and beside them ``{"cross_kv":
KVCache}`` of the encoder's K/V in a decoder with cross-attention;
prefill and decode write into their tensors in place, never replacing
them.  The MoE aux loss is dropped in serving; ``block_train`` (no cache,
no kernel: call it inside ``layers.plain_products``) returns it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import attention as attn
from . import mamba as mb
from . import xlstm as xl
from .config import LayerSpec, ModelConfig
from .layers import MLP, Norm, apply_norm, dense, init_norm, mlp
from .moe import MoE, moe_ffn

__all__ = ["Block", "init_block", "init_block_cache", "block_train", "block_prefill",
           "block_decode", "block_encode"]

_MIXERS = {"attn": attn.Attention, "mamba": mb.Mamba, "mlstm": xl.MLstm, "slstm": xl.SLstm}
_TRAIN_MIXERS = {"mamba": mb.mamba_train, "mlstm": xl.mlstm_train, "slstm": xl.slstm_train}


class Block(nn.Module):
    """norm1, mixer (Attention, Mamba, MLstm or SLstm); with ``cross``:
    norm_cross and cross (Attention without qk-norm); for ffn != none:
    norm2, ffn (MLP or MoE)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, dtype, device, cross: bool = False):
        super().__init__()
        self.spec = spec
        self.norm1 = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.mixer = _MIXERS[spec.mixer](cfg, dtype, device)
        self.has_cross = cross
        if cross:
            self.norm_cross = Norm(cfg.norm, cfg.d_model, dtype, device)
            self.cross = attn.Attention(cfg, dtype, device, cross=True)
        if spec.ffn != "none":
            self.norm2 = Norm(cfg.norm, cfg.d_model, dtype, device)
            if spec.ffn == "mlp":
                self.ffn = MLP(cfg.d_model, cfg.d_ff, dtype, device)
            else:
                self.ffn = MoE(cfg, dtype, device)


def init_block(block: Block, gen: torch.Generator) -> None:
    init_norm(block.norm1)
    block.mixer.init(gen)
    if block.has_cross:
        init_norm(block.norm_cross)
        block.cross.init(gen)
    if block.spec.ffn != "none":
        init_norm(block.norm2)
        block.ffn.init(gen)


def init_block_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device, cross_ctx: int = 0):
    """Zero-initialized per-layer cache for decode, with ``cross_ctx``
    encoder positions of cross-attention K/V where it is not 0.  The Mamba
    conv buffer holds ``dtype``, as a prefill leaves it (JAX's tail of the
    prompt's activations); the xLSTM states are float32."""
    if spec.mixer == "attn":
        cache = {"kv": _zero_kv(cfg, batch, max_len, dtype, device)}
    elif spec.mixer == "mamba":
        cache = {"ssm": mb.init_mamba_state(cfg, batch, device, dtype)}
    elif spec.mixer == "mlstm":
        cache = {"xl": xl.init_mlstm_state(cfg, batch, device)}
    else:
        cache = {"xl": xl.init_slstm_state(cfg, batch, device)}
    if cross_ctx:
        cache["cross_kv"] = _zero_kv(cfg, batch, cross_ctx, dtype, device)
    return cache


def _zero_kv(cfg, batch: int, length: int, dtype, device) -> attn.KVCache:
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return attn.KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device))


def _ffn_apply(p: Block, cfg, spec: LayerSpec, x):
    """-> (x, MoE aux loss or 0.0)."""
    if spec.ffn == "none":
        return x, 0.0
    h = apply_norm(p.norm2, x, cfg.norm)
    if spec.ffn == "mlp":
        return x + mlp(p.ffn, h), 0.0
    y, aux = moe_ffn(p.ffn, cfg, h)
    return x + y, aux


def _copy_into(bufs, values) -> None:
    for buf, value in zip(bufs, values):
        buf.copy_(value)


def _cross(p: Block, cfg, x, enc_kv: attn.KVCache):
    h = apply_norm(p.norm_cross, x, cfg.norm)
    return x + attn.cross_attention(p.cross, cfg, h, enc_kv)


def block_encode(p: Block, cfg, x):
    """One encoder layer (attn + mlp) over x [B, S_enc, D]: non-causal
    attention without rope, then the MLP (JAX ``Model._encode``'s step)."""
    h = apply_norm(p.norm1, x, cfg.norm)
    q, k, v = attn._qkv(p.mixer, cfg, h, None, rope=False)
    y = attn._sdpa_small(q, k, v, None, cfg.head_dim ** -0.5)
    x = x + dense(y, p.mixer.wo)
    x, _ = _ffn_apply(p, cfg, p.spec, x)
    return x


def block_train(p: Block, cfg, spec: LayerSpec, x, window: Optional[int] = None,
                enc_out=None):
    """The block over x [B, S, D] for training, with cross-attention to
    ``enc_out`` where the block has it -> (x, MoE aux loss or 0.0); JAX
    ``block_train``."""
    h = apply_norm(p.norm1, x, cfg.norm)
    if spec.mixer == "attn":
        x = x + attn.attention_train(p.mixer, cfg, h, window)
    else:
        x = x + _TRAIN_MIXERS[spec.mixer](p.mixer, cfg, h)
    if p.has_cross and enc_out is not None:
        x = _cross(p, cfg, x, attn.encode_kv(p.cross, cfg, enc_out))
    return _ffn_apply(p, cfg, spec, x)


def block_prefill(p: Block, cfg, spec: LayerSpec, x, cache,
                  window: Optional[int] = None, enc_out=None):
    """Runs the block over the prompt; writes the prompt's K/V into the
    cache buffer at offset 0, or the final Mamba or xLSTM state into the
    cache's state tensors, and with ``enc_out`` [B, S_enc, D] the encoder's
    cross K/V into ``cross_kv`` (in place)."""
    h = apply_norm(p.norm1, x, cfg.norm)
    if spec.mixer == "attn":
        y, kv = attn.attention_prefill(p.mixer, cfg, h, window)
        buf = cache["kv"]
        s = kv.k.shape[1]
        buf.k[:, :s] = kv.k.to(buf.k.dtype)
        buf.v[:, :s] = kv.v.to(buf.v.dtype)
    elif spec.mixer == "mamba":
        y, final = mb.mamba_prefill(p.mixer, cfg, h)
        _copy_into(cache["ssm"], final)
    else:  # xLSTM: the final state comes out of the scan
        scan = xl._mlstm_scan if spec.mixer == "mlstm" else xl._slstm_scan
        y, final = scan(p.mixer, cfg, h)
        _copy_into(cache["xl"], final)
    x = x + y
    if p.has_cross and enc_out is not None:
        enc_kv = attn.encode_kv(p.cross, cfg, enc_out)
        x = _cross(p, cfg, x, enc_kv)
        _copy_into(cache["cross_kv"], enc_kv)
    x, _ = _ffn_apply(p, cfg, spec, x)
    return x, cache


def block_decode(p: Block, cfg, spec: LayerSpec, x, cache, cache_len,
                 window: Optional[int] = None):
    h = apply_norm(p.norm1, x, cfg.norm)
    if spec.mixer == "attn":
        y, _ = attn.attention_decode(p.mixer, cfg, h, cache["kv"], cache_len, window)
    elif spec.mixer == "mamba":
        y, _ = mb.mamba_decode(p.mixer, cfg, h, cache["ssm"])
    else:
        decode = xl.mlstm_decode if spec.mixer == "mlstm" else xl.slstm_decode
        y, _ = decode(p.mixer, cfg, h, cache["xl"])
    x = x + y
    if p.has_cross and "cross_kv" in cache:
        x = _cross(p, cfg, x, cache["cross_kv"])
    x, _ = _ffn_apply(p, cfg, spec, x)
    return x, cache
