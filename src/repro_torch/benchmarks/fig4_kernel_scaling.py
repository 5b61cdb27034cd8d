"""Fig. 4 / Eq. 3 on the card: the pinned matmul's time against its SMs.

Counterpart of ``benchmarks/fig4_kernel_scaling.py``, which on the CPU
builds t(m) from Eq. 3 and fits Eq. 3 to it.  Here t(m) is measured: the
pinned matmul (``kernels.persistent_matmul``, Algorithm 1) alone with
``n_bands`` = m, for m = 1 .. the card's SMs, each time the device time of
one call from calls captured into a CUDA graph and replayed between CUDA
events, the weights cycling beyond the 50 MB L2.  Eq. 3,
t(m) = (C − L)/m + L, is fitted by least squares in 1/m (:func:`fit_eq3`).
The shapes (:data:`SHAPES`): the JAX benchmark's own and qwen3-0.6b's MLP
up-projection at its prefill and at its decode step.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["SHAPES", "fit_eq3", "curve_rows", "measure_curve", "shape_curve",
           "bands_of_card"]

# row-name suffix -> (M, K, N, dtype): the JAX file's shape, then qwen3-0.6b's
# up-projection at a prefill of 4 x 256 tokens and at a decode step of 4
SHAPES = {
    "": (1024, 256, 512, "float32"),
    "_qwen_prefill_up": (1024, 1024, 3072, "bfloat16"),
    "_qwen_decode_up": (4, 1024, 3072, "bfloat16"),
}
CYCLE_BYTES = 64 << 20   # the weights a graph cycles through, beyond the L2


def fit_eq3(bands: Sequence[int], t: Sequence[float]) -> dict:
    """Least squares of t = (C − L)/m + L in 1/m: C (the work on one SM),
    L (the part no SM count shortens) and R² of the fit (nan for a flat
    t(m), which no SM count shortens)."""
    inv = 1.0 / np.asarray(bands, dtype=np.float64)
    y = np.asarray(t, dtype=np.float64)
    slope, l_fit = np.polyfit(inv, y, 1)
    resid = y - (slope * inv + l_fit)
    total = float(np.sum((y - y.mean()) ** 2))   # 0 for a flat t(m): R² undefined
    r2 = 1.0 - float(np.sum(resid ** 2)) / total if total else float("nan")
    return {"c": float(slope + l_fit), "l": float(l_fit), "r2": r2}


def curve_rows(suffix: str, bands: Sequence[int], t_us: Sequence[float], units: int) -> list:
    """The rows of one shape's curve: the JAX benchmark's (R², per-tile µs,
    t at each band count, the speedup from 1 to 8 bands), each name with
    ``suffix``, then Eq. 3's C and L.  ``units``: the launch's work units
    on one band, so t(1) / units is a unit's time."""
    t = dict(zip(bands, t_us))
    fit = fit_eq3(bands, t_us)
    rows = [(f"fig4_eq3_fit_r2{suffix}", fit["r2"]),
            (f"fig4_per_tile_us{suffix}", t[1] / units)]
    rows += [(f"fig4_t_bands{b}_us{suffix}", t[b]) for b in bands]
    rows += [(f"fig4_speedup_8bands{suffix}", t[1] / t[8]),
             (f"fig4_eq3_c_us{suffix}", fit["c"]), (f"fig4_eq3_l_us{suffix}", fit["l"])]
    return rows


def measure_curve(shape, bands: Sequence[int], seed: int = 0) -> list[float]:
    """t(m) in µs of one pinned matmul of ``shape`` = (M, K, N, dtype) on
    each band count of ``bands``, on the card."""
    import torch

    from repro_torch.kernels.persistent_matmul import persistent_matmul

    m, k, n, dt = shape
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    copies = max(1, min(16, -(-CYCLE_BYTES // (k * n * dtype.itemsize))))
    ws = [torch.randn(k, n, device="cuda", generator=gen).to(dtype) for _ in range(copies)]
    iters = copies * max(1, 8 // copies)
    out = []
    for b in bands:
        def calls():
            for i in range(iters):
                persistent_matmul(x, ws[i % copies], n_bands=b)

        calls()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            calls()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) * 1e3 / (3 * iters))
        del graph
    return out


def shape_curve(suffix: str, bands: Sequence[int]) -> tuple[list[float], list]:
    """:data:`SHAPES`' ``suffix`` shape measured on each of ``bands`` (card
    only): t(m) in µs and the shape's rows."""
    import torch

    from repro_torch.kernels.persistent_matmul import tile_grid

    m, k, n, dt = SHAPES[suffix]
    units = tile_grid(m, k, n, getattr(torch, dt), 1).units
    t_us = measure_curve(SHAPES[suffix], bands)
    return t_us, curve_rows(suffix, bands, t_us, units)


def bands_of_card() -> list[int]:
    """m = 1 .. the card's SMs."""
    import torch

    return list(range(1, torch.cuda.get_device_properties(0).multi_processor_count + 1))
