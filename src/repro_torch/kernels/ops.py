"""Model-facing wrappers around the hand kernels.

They adapt model-layer shapes to kernel layouts (contiguous scan
operands); attention needs no adapting, since the flash kernel reads the
model's [B, S, H, hd] layout and GQA itself.  A CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the kernel; there is no
other fallback.  A meta tensor (the dry run's) goes the kernel's way, and
the kernel's wrapper returns empty meta outputs and counts its work.  The kernels have no backward: a CUDA input that requires
a gradient while grad mode is on raises (training runs plain products, as
the JAX package's training reaches no Pallas kernel).  The TPU wrappers'
divisibility rules do not apply: the CUDA kernels mask ragged edges.

``on_sms(n, first)`` scopes the SMs the model's projections run on: inside
it ``sm_range()`` is ``(n, first)``, and ``models.layers.dense`` passes it
to every ``pinned_matmul`` as ``n_bands`` and ``first_sm``.  Only the
pinned matmul honours it; flash attention, the scan, the plain ops and the
MoE experts run on every SM.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import torch

from .flash_attention import flash_attention_gqa
from .persistent_matmul import persistent_matmul
from .ref import matmul_ref, mha_flash_ref, selective_scan_ref
from .selective_scan import selective_scan

__all__ = ["pinned_matmul", "mha_flash", "mamba_scan", "on_sms", "sm_range"]

_SM_RANGE: contextvars.ContextVar[tuple[Optional[int], int]] = contextvars.ContextVar(
    "sm_range", default=(None, 0))


@contextlib.contextmanager
def on_sms(n_bands: Optional[int], first_sm: int = 0) -> Iterator[None]:
    """Inside the block, the model's pinned matmuls run on ``n_bands`` of
    the card's SMs from the ``first_sm``-th on (all SMs if None): a task's
    granted GN, at its place on the card."""
    token = _SM_RANGE.set((n_bands, first_sm))
    try:
        yield
    finally:
        _SM_RANGE.reset(token)


def sm_range() -> tuple[Optional[int], int]:
    """``(n_bands, first_sm)`` set by the innermost :func:`on_sms`
    (``(None, 0)``: all SMs)."""
    return _SM_RANGE.get()


def _pick_block(n: int, target: int) -> int:
    """The TPU wrapper's block choice: the largest divisor of n <= target."""
    b = min(target, n)
    while n % b:
        b -= 1
    return max(b, 1)


def _no_backward(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel}: the hand kernel has no backward; an input requires "
                           "a gradient (train through models.layers.plain_products)")


def pinned_matmul(x: torch.Tensor, w: torch.Tensor, *, n_bands: Optional[int] = None,
                  first_sm: int = 0) -> torch.Tensor:
    """x [M, K] @ w [K, N] on the task's ``n_bands`` SMs from the
    ``first_sm``-th on (all SMs if None)."""
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    _no_backward("persistent_matmul", x, w)
    return persistent_matmul(x, w, n_bands, first_sm)


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, window: Optional[int] = None) -> torch.Tensor:
    """q: [B, S, H, hd]; k/v: [B, S, Hkv, hd] -> [B, S, H*hd].  On the card
    one kernel launch reads the tensors as they are: no copy."""
    if q.device.type == "cpu":
        return mha_flash_ref(q, k, v, scale=scale, window=window)
    _no_backward("flash_attention", q, k, v)
    return flash_attention_gqa(q, k, v, scale=scale, window=window)


def mamba_scan(abar: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """abar/bx [B, S, D, N], c [B, S, N], h0 [B, D, N] or None (zeros) ->
    (y [B, S, D] f32, final state [B, D, N] f32).  The TPU wrapper's chunk
    and d_block choices do not change the result, so none is made here."""
    if abar.device.type == "cpu":
        return selective_scan_ref(abar, bx, c, h0)
    _no_backward("selective_scan", abar, bx, c, h0)
    return selective_scan(abar.contiguous(), bx.contiguous(), c.contiguous(),
                          None if h0 is None else h0.contiguous())
