"""Causal flash attention (optional sliding window) — hand kernel for the H100.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, ``_kernel``).  The kernel is
``csrc/flash_attention.cu``: one CTA per (64-row query tile, batch·head),
float32 online softmax with the TPU kernel's masking and final division,
the KV loop bounded by the causal and window limits; bfloat16 runs both
products on the tensor cores, float32 on the CUDA cores.  See the source
for what bounds it and why.  GQA is handled upstream (``ops.mha_flash``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

__all__ = ["HEAD_DIMS", "flash_attention"]

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    lib.flash_attention.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                    ctypes.c_float, _I, _P]
    lib.flash_attention.restype = _I
    return lib


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
    with torch.cuda.device(q.device):
        err = _lib().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, hd,
            _DTYPES[q.dtype], float(scale), 0 if window is None else int(window),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
