"""Causal flash attention (optional sliding window) — hand kernel for the H100.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, ``_kernel``).  The kernel is
``csrc/flash_attention.cu``.  It reads the model's own layout and GQA:
q [B, S, H, hd] and k/v [B, S, Hkv, hd], query head h on KV head
h // (H // Hkv), and writes [B, S, H * hd].  Float32 online softmax with
the TPU kernel's masking and final division, the KV loop bounded by the
causal and window limits.  bfloat16 at hd 64 and 128 runs on
``flash_wgmma_kernel`` (TMA-fed K/V ring, ``wgmma`` products, both query
heads of a KV pair on one K/V stage); bfloat16 at hd 32 on
``flash_mma_kernel`` (``mma.sync``); float32 on ``flash_f32_kernel`` (CUDA
cores).  See the source for what bounds it and why.

Two entries share one kernel and one launch counter,
``flash_attention.launches``: :func:`flash_attention_gqa` on the model's
layout, and :func:`flash_attention` on the TPU kernel's [BH, S, hd] (a view
with B = BH and H = Hkv = 1).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch import roofline

from . import _build

__all__ = ["HEAD_DIMS", "causal_pairs", "flash_attention", "flash_attention_gqa",
           "kernel_name"]

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    lib.flash_attention.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _L, _L, _L, _L, _L, _L,
                                    _I, ctypes.c_float, _I, _P]
    lib.flash_attention.restype = _I
    return lib


def kernel_name(dtype: torch.dtype, hd: int) -> str:
    """The CUDA kernel a call with this dtype and head dim launches."""
    if dtype not in _DTYPES or hd not in HEAD_DIMS:
        raise ValueError(f"no flash kernel for {dtype} at head_dim {hd}")
    if dtype == torch.float32:
        return "flash_f32_kernel"
    return "flash_mma_kernel" if hd == 32 else "flash_wgmma_kernel"


def _strides(t: torch.Tensor) -> tuple[int, int]:
    """(batch, position) element strides of a [B, S, heads, hd] tensor; a
    dimension of size 1 takes the stride a packed tensor would have."""
    b, s, heads, hd = t.shape
    ss = t.stride(1) if s > 1 else heads * hd
    return (t.stride(0) if b > 1 else s * ss), ss


def _launch(q, k, v, out, scale: float, window: Optional[int]) -> None:
    """Launch the kernel on checked [B, S, H, hd] / [B, S, Hkv, hd] tensors
    into out [B, S, H * hd]; counts one launch."""
    b, s, h, hd = q.shape
    with torch.cuda.device(q.device):
        err = _lib().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, k.shape[2],
            hd, *_strides(q), *_strides(k), *_strides(v), _DTYPES[q.dtype], float(scale),
            0 if window is None else int(window), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1


def causal_pairs(s: int, window: Optional[int] = None) -> int:
    """(query, key) pairs the kernel computes over S positions: key j for
    query i where j <= i (and j > i - window)."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float, window: Optional[int] = None) -> torch.Tensor:
    """q [B, S, H, hd], k/v [B, S, Hkv, hd] on one CUDA device -> [B, S, H*hd]
    in q.dtype.  Each tensor's last dimension is contiguous with heads
    packed in a row (head stride hd); batch and position strides are
    multiples of 16 bytes and the bases 16-byte aligned.  Nothing is
    copied: a tensor the kernel does not take raises.  On the meta device
    (the dry run's): an empty [B, S, H*hd], the kernel's products over the
    ``causal_pairs`` counted by the active ``roofline.analyze_step``;
    nothing launches."""
    if q.device.type == "meta":
        b, s, h, hd = q.shape
        out = torch.empty((b, s, h * hd), dtype=q.dtype, device="meta")
        # QK^T and PV: 2 hd FLOPs each per (query, key) pair and head
        roofline.record_kernel(4 * b * h * hd * causal_pairs(s, window), (q, k, v), (out,))
        return out
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_gqa takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or \
            (k.shape[0], k.shape[1], k.shape[3]) != (q.shape[0], q.shape[1], q.shape[3]):
        raise ValueError(f"q must be [B, S, H, hd] and k/v [B, S, Hkv, hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if min(b, s, h, hkv) < 1 or h % hkv:
        raise ValueError(f"{h} query heads do not share {hkv} KV heads evenly")
    if window is not None and window < 1:
        raise ValueError("window must be >= 1")
    align = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or (t.shape[2] > 1 and t.stride(2) != hd):
            raise ValueError(f"flash_attention_gqa needs {name}'s last dimension "
                             f"contiguous and its heads packed (strides {t.stride()})")
        if any(st % align for st in _strides(t)) or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_gqa needs {name} 16-byte aligned, with "
                             f"16-byte batch and position strides (strides {t.stride()})")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_gqa needs q, k and v on one CUDA device")
    out = torch.empty((b, s, h * hd), dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, scale, window)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, window: Optional[int] = None) -> torch.Tensor:
    """q/k/v: [BH, S, hd] on one CUDA device -> [BH, S, hd] in q.dtype."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention needs q, k and v on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [BH, S, hd] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not 1 <= bh <= 65535 or bh * s * hd >= 2 ** 31:
        raise ValueError(f"shape {tuple(q.shape)} out of the kernel's range")
    if window is not None and window < 1:
        raise ValueError("window must be >= 1")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned q, k and v")
    out = torch.empty_like(q)
    _launch(*(t.view(bh, s, 1, hd) for t in (q, k, v)), out, scale, window)
    return out


flash_attention.launches = 0
