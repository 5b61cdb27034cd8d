"""Model-facing wrappers around the hand kernels.

They adapt model-layer shapes to kernel layouts (contiguous scan
operands); attention needs no adapting, since the flash kernel reads the
model's [B, S, H, hd] layout and GQA itself.  A CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the kernel; there is no
other fallback.  The TPU wrappers' divisibility rules do not apply: the
CUDA kernels mask ragged edges.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention_gqa
from .persistent_matmul import persistent_matmul
from .ref import matmul_ref, mha_flash_ref, selective_scan_ref
from .selective_scan import selective_scan

__all__ = ["pinned_matmul", "mha_flash", "mamba_scan"]


def _pick_block(n: int, target: int) -> int:
    """The TPU wrapper's block choice: the largest divisor of n <= target."""
    b = min(target, n)
    while n % b:
        b -= 1
    return max(b, 1)


def pinned_matmul(x: torch.Tensor, w: torch.Tensor, *,
                  n_bands: Optional[int] = None) -> torch.Tensor:
    """x [M, K] @ w [K, N] on the task's ``n_bands`` SMs (all SMs if None)."""
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    return persistent_matmul(x, w, n_bands)


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, window: Optional[int] = None) -> torch.Tensor:
    """q: [B, S, H, hd]; k/v: [B, S, Hkv, hd] -> [B, S, H*hd].  On the card
    one kernel launch reads the tensors as they are: no copy."""
    if q.device.type == "cpu":
        return mha_flash_ref(q, k, v, scale=scale, window=window)
    return flash_attention_gqa(q, k, v, scale=scale, window=window)


def mamba_scan(abar: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """abar/bx [B, S, D, N], c [B, S, N], h0 [B, D, N] or None (zeros) ->
    (y [B, S, D] f32, final state [B, D, N] f32).  The TPU wrapper's chunk
    and d_block choices do not change the result, so none is made here."""
    if abar.device.type == "cpu":
        return selective_scan_ref(abar, bx, c, h0)
    return selective_scan(abar.contiguous(), bx.contiguous(), c.contiguous(),
                          None if h0 is None else h0.contiguous())
