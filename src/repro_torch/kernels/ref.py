"""Plain PyTorch versions of the hand kernels (the allclose ground truth).

Counterparts of ``repro.kernels.ref``: the CPU path runs them, and
``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["matmul_ref", "flash_attention_ref", "mha_flash_ref", "selective_scan_ref"]


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ w [K, N], accumulated in float32, returned in x.dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def flash_attention_ref(q, k, v, *, scale: float, window: Optional[int] = None):
    """q/k/v: [BH, S, hd]; causal (+ optional sliding window)."""
    s = q.shape[1]
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(s, device=q.device)[None, :]
    mask = kj <= qi
    if window is not None:
        mask &= kj > qi - window
    logits = logits.masked_fill(~mask[None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum(
        "bqk,bkd->bqd", probs.to(v.dtype).float(), v.float()
    ).to(q.dtype)


def mha_flash_ref(q, k, v, *, scale: float, window: Optional[int] = None):
    """q: [B, S, H, hd]; k/v: [B, S, Hkv, hd] -> [B, S, H*hd]: the flash
    kernel's [B, S, H, hd] function, as the JAX wrapper computes it (KV
    heads repeated to the query heads, heads flattened into the batch)."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    kf = k.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    vf = v.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    out = flash_attention_ref(qf, kf, vf, scale=scale, window=window)
    return out.reshape(b, h, s, hd).transpose(1, 2).reshape(b, s, h * hd)


def selective_scan_ref(abar, bx, c, h0=None):
    """abar/bx [B, S, D, N], c [B, S, N], h0 [B, D, N] (zeros if None) ->
    (y [B, S, D], final state [B, D, N]), a loop over t in float32."""
    b, s, d, n = abar.shape
    if h0 is None:
        h = torch.zeros((b, d, n), dtype=torch.float32, device=abar.device)
    else:
        h = h0.float()
    ys = []
    for t in range(s):
        h = abar[:, t].float() * h + bx[:, t].float()
        ys.append((h * c[:, t, None, :].float()).sum(-1))
    return torch.stack(ys, dim=1), h
