"""Grouped-query attention: prefill and decode-with-cache paths, and
cross-attention to an encoder's states.

Counterpart of ``repro.models.attention``: GQA (any n_heads/n_kv_heads
ratio), qk-norm (Qwen3), half-split rotary, causal and sliding-window
masking, and the Whisper decoder's cross-attention (no rope, no mask, no
qk-norm on its projections).  Causal prefill attention runs through
``kernels.ops.mha_flash`` at every sequence length: on the card one launch
of the hand flash kernel, which reads q [B, S, H, hd] and k/v [B, S, Hkv,
hd] as this module makes them (GQA included) and writes [B, S, H*hd], the
output projection's input.  Decode attention (one query over the cache),
cross-attention and the encoder's non-causal attention stay plain
PyTorch products with a float32-logits softmax (``_sdpa_small``), as the
JAX package computes them outside its causal Pallas kernel.

Training (``attention_train``) reaches no kernel, as JAX's does not: its
products are plain (``layers.plain_products``), and its causal attention
is JAX's ``_causal_attention`` in plain PyTorch, which autograd
differentiates: ``_sdpa_small`` under a causal (or windowed) mask up to
``_SMALL_SEQ`` positions, the blocked running-max ``_flash_sdpa`` above.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.kernels import ops

from .layers import _weight, apply_rotary, dense, init_dense, rms_norm, rotary_cos_sin

__all__ = ["KVCache", "Attention", "attention_train", "attention_prefill", "attention_decode",
           "cross_attention", "encode_kv"]


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S, n_kv, hd]
    v: torch.Tensor  # [B, S, n_kv, hd]


class Attention(nn.Module):
    """wq [d, H*hd], wk/wv [d, Hkv*hd], wo [H*hd, d]; q_norm/k_norm [hd]
    where the config has qk-norm and the projections are not ``cross``
    (JAX ``init_attention``)."""

    def __init__(self, cfg, dtype, device, cross: bool = False):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        self.wq = _weight((d, cfg.n_heads * hd), dtype, device)
        self.wk = _weight((d, cfg.n_kv_heads * hd), dtype, device)
        self.wv = _weight((d, cfg.n_kv_heads * hd), dtype, device)
        self.wo = _weight((cfg.n_heads * hd, d), dtype, device)
        self.qk_norm = cfg.qk_norm and not cross
        if self.qk_norm:
            self.q_norm = _weight((hd,), dtype, device)
            self.k_norm = _weight((hd,), dtype, device)

    def init(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            init_dense(w, gen)
        if self.qk_norm:
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _qkv(params: Attention, cfg, x, positions, rope: bool = True):
    """q [..., H, hd], k and v [..., Hkv, hd]; rotary at ``positions``
    unless ``rope`` is False (the encoder's)."""
    hd = cfg.head_dim
    q = _split_heads(dense(x, params.wq), cfg.n_heads, hd)
    k = _split_heads(dense(x, params.wk), cfg.n_kv_heads, hd)
    v = _split_heads(dense(x, params.wv), cfg.n_kv_heads, hd)
    if params.qk_norm:
        q = rms_norm(q, params.q_norm)
        k = rms_norm(k, params.k_norm)
    if not rope:
        return q, k, v
    cos, sin = rotary_cos_sin(positions, hd, cfg.rope_theta)
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v


def _expand_kv(k, group: int):
    """GQA: repeat each KV head ``group`` times on the head axis."""
    return k if group == 1 else k.repeat_interleave(group, dim=2)


def _sdpa_small(q, k, v, mask, scale):
    """Materialized-logits attention: decode (one query over the cache),
    cross-attention and the encoder (non-causal, ``mask`` None).

    q: [B,Sq,H,hd]; k/v: [B,Sk,Hkv,hd]; mask: [B,Sq,Sk] or None."""
    b, sq, h, hd = q.shape
    group = h // k.shape[2]
    k = _expand_kv(k, group)
    v = _expand_kv(v, group)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, :, :], -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(v.dtype)
    return out.reshape(b, sq, h * hd)


def _causal_attention(q, k, v, scale, window):
    """Prefill attention: the hand flash kernel on the card (one launch, no
    copy of q, k or v), its plain version on the CPU, at every sequence
    length."""
    return ops.mha_flash(q, k, v, scale=scale, window=window)


def _causal_mask(sq: int, sk: int, window: Optional[int], device, q0: int = 0,
                 k0: int = 0) -> torch.Tensor:
    """[sq, sk] True = attend, for queries from position q0 and keys from
    k0: query i sees key j iff j <= i and (no window or j > i - window)."""
    qi = q0 + torch.arange(sq, device=device)[:, None]
    kj = k0 + torch.arange(sk, device=device)[None, :]
    mask = kj <= qi
    if window is not None:
        mask &= kj > qi - window
    return mask


def _flash_sdpa(q, k, v, scale, window: Optional[int], q_block: int = 512,
                kv_block: int = 1024):
    """Blocked causal attention with a running max and sum over KV blocks
    (JAX ``_flash_sdpa``): one [B, H, q_block, kv_block] float32 logits tile
    at a time.  q: [B, S, H, hd]; k/v: [B, S, Hkv, hd] -> [B, S, H*hd]."""
    b, s, h, hd = q.shape
    group = h // k.shape[2]
    k = _expand_kv(k, group)
    v = _expand_kv(v, group)
    outs = []
    for qs in range(0, s, q_block):
        qtile = q[:, qs:qs + q_block].float()
        m_run = q.new_full((b, h, q_block), -math.inf, dtype=torch.float32)
        l_run = q.new_zeros((b, h, q_block), dtype=torch.float32)
        acc = q.new_zeros((b, h, q_block, hd), dtype=torch.float32)
        for ks in range(0, s, kv_block):
            vtile = v[:, ks:ks + kv_block]
            logits = torch.einsum("bqhd,bkhd->bhqk", qtile,
                                  k[:, ks:ks + kv_block].float()) * scale
            mask = _causal_mask(q_block, kv_block, window, q.device, qs, ks)
            logits = torch.where(mask, logits, -1e30)
            m_new = torch.maximum(m_run, logits.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(logits - m_new[..., None])
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vtile.dtype).float(), vtile.float())
            m_run = m_new
        outs.append((acc / l_run.clamp_min(1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, h * hd)


_SMALL_SEQ = 1024  # sequences at or below this use materialized-logits attention


def _largest_divisor_block(s: int, cap: int = 512) -> int:
    for blk in range(min(cap, s), 0, -1):
        if s % blk == 0:
            return blk
    return 1


def _causal_attention_train(q, k, v, scale, window):
    """JAX ``_causal_attention`` in plain PyTorch: ``_sdpa_small`` under the
    causal mask up to ``_SMALL_SEQ`` positions, ``_flash_sdpa`` above it
    with JAX's block choice."""
    b, s = q.shape[:2]
    if s <= _SMALL_SEQ:
        mask = _causal_mask(s, s, window, q.device)[None].expand(b, s, s)
        return _sdpa_small(q, k, v, mask, scale)
    qb = 512 if s % 512 == 0 else _largest_divisor_block(s)
    kb = 1024 if s % 1024 == 0 else qb
    return _flash_sdpa(q, k, v, scale, window, q_block=qb, kv_block=kb)


def attention_train(params: Attention, cfg, x, window: Optional[int] = None):
    """Causal self-attention over x [B, S, D] for training: no cache, no
    kernel (call inside ``layers.plain_products``)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _qkv(params, cfg, x, positions)
    out = _causal_attention_train(q, k, v, cfg.head_dim ** -0.5, window)
    return dense(out, params.wo)


def attention_prefill(params: Attention, cfg, x, window: Optional[int] = None):
    """Returns (output, KVCache) for subsequent decode."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _qkv(params, cfg, x, positions)
    out = _causal_attention(q, k, v, cfg.head_dim ** -0.5, window)
    return dense(out, params.wo), KVCache(k=k, v=v)


def attention_decode(params: Attention, cfg, x, cache: KVCache, cache_len,
                     window: Optional[int] = None):
    """One-token decode: x [B,1,D]; cache holds S_max past positions.

    ``cache_len`` [B] int — number of valid positions.  The new token is
    written at clip(cache_len, 0, S_max-1).  Unlike the JAX version, which
    returns a new buffer, the write is in place: ``cache`` is updated and
    returned."""
    b, one, _ = x.shape
    if one != 1:
        raise ValueError("attention_decode takes one token per row")
    s_max = cache.k.shape[1]
    q, k_new, v_new = _qkv(params, cfg, x, cache_len[:, None])

    rows = torch.arange(b, device=x.device)
    slot = cache_len.clamp(0, s_max - 1)
    cache.k[rows, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v_new[:, 0].to(cache.v.dtype)

    kj = torch.arange(s_max, device=x.device)[None, :]  # [1, S]
    valid = kj <= cache_len[:, None]  # include the just-written slot
    if window is not None:
        valid &= kj > cache_len[:, None] - window
    out = _sdpa_small(q, cache.k, cache.v, valid[:, None, :], cfg.head_dim ** -0.5)
    return dense(out, params.wo), cache


def cross_attention(params: Attention, cfg, x, enc_kv: KVCache):
    """Decoder cross-attention to fixed encoder states, x [B, S, D] against
    enc_kv's [B, S_enc, Hkv, hd] (no rope, no mask)."""
    q = _split_heads(dense(x, params.wq), cfg.n_heads, cfg.head_dim)
    out = _sdpa_small(q, enc_kv.k, enc_kv.v, None, cfg.head_dim ** -0.5)
    return dense(out, params.wo)


def encode_kv(params: Attention, cfg, enc_out):
    """Cross-attention K/V [B, S_enc, Hkv, hd] of the encoder output."""
    k = _split_heads(dense(enc_out, params.wk), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(dense(enc_out, params.wv), cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=k, v=v)
