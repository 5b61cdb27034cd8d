"""Hardware constants of the port's target card, one NVIDIA H100 SXM.

From NVIDIA's data sheet (dense rates, at the full 700 W power limit); a
card set to a lower limit runs below them.  The HLO analyzer of
``repro.roofline`` has no counterpart yet.
"""
from __future__ import annotations

__all__ = ["PEAK_FLOPS", "PEAK_FLOPS_F32", "HBM_BW"]

PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12  # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12     # HBM3 bytes/s
