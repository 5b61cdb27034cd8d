"""Plain PyTorch versions of the hand kernels (the allclose ground truth).

Counterparts of ``repro.kernels.ref``: the CPU path runs them, and
``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["matmul_ref", "flash_attention_ref", "selective_scan_ref"]


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
