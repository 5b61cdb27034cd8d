"""Selective scan (Mamba's SSM recurrence) — hand kernel for the H100.

Replaces the Pallas TPU kernel ``repro/kernels/selective_scan.py``
(``selective_scan``, ``_kernel``).  The kernel is ``csrc/selective_scan.cu``:
the time axis is a loop inside the thread, N/4 neighbouring threads share a
channel (b, d) with four f32 states each, and y is reduced over them with
warp shuffles.  Besides the TPU kernel's function it takes an initial state
and returns the final one, which the model carries across its time chunks.
See the source for what bounds it and why.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch import roofline

from . import _build

__all__ = ["N_STATES", "selective_scan"]

N_STATES = (4, 8, 16)
_C_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("selective_scan")
    lib.selective_scan.argtypes = [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.selective_scan.restype = _I
    return lib


def selective_scan(abar: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """abar/bx [B, S, D, N] f32, c [B, S, N] f32 or bf16, h0 [B, D, N] f32
    (zeros if None), all on one CUDA device -> (y [B, S, D] f32, the state
    after the last step [B, D, N] f32).  On the meta device (the dry
    run's): empty outputs, the kernel's work counted by the active
    ``roofline.analyze_step``; nothing launches."""
    if abar.device.type == "meta":
        b, s, d, n = abar.shape
        y = torch.empty((b, s, d), dtype=torch.float32, device="meta")
        h = torch.empty((b, d, n), dtype=torch.float32, device="meta")
        # per element: h = abar * h + bx (2 FLOPs), y += c * h (2)
        roofline.record_kernel(4 * b * s * d * n, (abar, bx, c, h0), (y, h))
        return y, h
    tensors = [abar, bx, c] + ([] if h0 is None else [h0])
    if not (abar.is_cuda and all(t.device == abar.device for t in tensors)):
        raise ValueError("selective_scan needs abar, bx, c and h0 on one CUDA device")
    if abar.dtype != torch.float32 or bx.dtype != torch.float32 or \
            (h0 is not None and h0.dtype != torch.float32):
        raise TypeError("selective_scan takes float32 abar, bx and h0")
    if c.dtype not in _C_DTYPES:
        raise TypeError(f"selective_scan takes float32 or bfloat16 c, got {c.dtype}")
    if abar.dim() != 4 or bx.shape != abar.shape:
        raise ValueError(f"abar and bx must share one [B, S, D, N] shape, got "
                         f"{tuple(abar.shape)}, {tuple(bx.shape)}")
    b, s, d, n = abar.shape
    if c.shape != (b, s, n) or (h0 is not None and h0.shape != (b, d, n)):
        raise ValueError(f"c must be {(b, s, n)} and h0 {(b, d, n)}, got "
                         f"{tuple(c.shape)}, {None if h0 is None else tuple(h0.shape)}")
    if n not in N_STATES:
        raise ValueError(f"d_state {n} not in {N_STATES}")
    if min(b, s, d) < 1 or b * d * n // 4 >= 2 ** 31:
        raise ValueError(f"shape {tuple(abar.shape)} out of the kernel's range")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("selective_scan needs contiguous abar, bx, c and h0")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("selective_scan needs 16-byte aligned abar, bx, c and h0")
    y = torch.empty((b, s, d), dtype=torch.float32, device=abar.device)
    h_out = torch.empty((b, d, n), dtype=torch.float32, device=abar.device)
    with torch.cuda.device(abar.device):
        err = _lib().selective_scan(
            abar.data_ptr(), bx.data_ptr(), c.data_ptr(), _C_DTYPES[c.dtype],
            None if h0 is None else h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
            b, s, d, n, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"selective_scan launch failed: CUDA error {err}")
    selective_scan.launches += 1
    return y, h_out


selective_scan.launches = 0
