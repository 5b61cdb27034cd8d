"""Persistent matmul pinned to SMs — the paper's Algorithm 1 on the H100.

Replaces the Pallas TPU kernel ``repro/kernels/persistent_matmul.py``
(``persistent_matmul``; ``_kernel`` and ``tile_of``).  The kernel is
``csrc/persistent_matmul.cu``: persistent CTAs read ``%smid`` and return
unless their SM is one of the task's ``n_bands`` SMs; on each allocated SM
two CTAs claim lanes 0 and 1 (the self-interleaved halves) and walk
``tile_of``'s map.  See the source for what bounds it and why.

The allocated SMs are the first ``n_bands`` SM ids the card reports, found
once per device by a probe kernel (SM ids need not be contiguous).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from . import _build

__all__ = ["TileTrace", "tile_shape", "tile_grid", "tile_of",
           "sm_ids", "persistent_matmul", "persistent_matmul_traced"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def tile_shape(m: int) -> tuple[int, int]:
    """(rows, cols) of an output tile: the kernel's decode variant takes
    4 x 16 tiles for M <= 4; the tiled variant 16 x 64 or 64 x 64."""
    if m <= 4:
        return 4, 16
    return (16, 64) if m <= 16 else (64, 64)


def tile_grid(m: int, n: int, n_bands: int) -> tuple[int, int, int, int]:
    """(block_m, column tiles, total tiles, tiles per lane) for one launch."""
    bm, bn = tile_shape(m)
    n_tiles_n = -(-n // bn)
    total = -(-m // bm) * n_tiles_n
    return bm, n_tiles_n, total, -(-total // (2 * n_bands))


def tile_of(band: int, lane: int, step: int, tiles_per_lane: int,
            n_tiles_n: int) -> tuple[int, int]:
    """(row tile, col tile) for this (band, interleave lane, step).

    Band b owns the contiguous tile range [b*2T, (b+1)*2T); its two lanes
    interleave that range round-robin (Alg. 1's two halves).  Tiles at or
    past the end are masked by the kernel."""
    linear = band * (2 * tiles_per_lane) + step * 2 + lane
    return linear // n_tiles_n, linear % n_tiles_n


@dataclasses.dataclass(frozen=True)
class TileTrace:
    """What a traced launch saw: for each tile the SM that computed it and
    how many times it was computed, plus the kernel's finished-tile count."""
    tile_sm: torch.Tensor     # [tiles] int32, -1 if never computed
    tile_hits: torch.Tensor   # [tiles] int32
    tiles_done: int
    allowed_sms: tuple[int, ...]


_SM_IDS: dict[int, tuple[int, ...]] = {}
_BAND_TABLES: dict[tuple[int, int], torch.Tensor] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("persistent_matmul")
    lib.pinned_matmul.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I,
                                  _I, _I, _I, _P, _P, _P, _I, _P]
    lib.pinned_matmul.restype = _I
    lib.sm_probe.argtypes = [_P, _I, _P, _I, _P]
    lib.sm_probe.restype = _I
    return lib


def sm_ids(device: torch.device) -> tuple[int, ...]:
    """The %smid values of the card, in ascending order (probed once)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    ids = _SM_IDS.get(index)
    if ids is None:
        with torch.cuda.device(index):
            n_sms = torch.cuda.get_device_properties(index).multi_processor_count
            cap = 1024
            seen = torch.zeros(cap, dtype=torch.int32, device="cuda")
            n_ids = torch.zeros(1, dtype=torch.int32, device="cuda")
            err = _lib().sm_probe(seen.data_ptr(), cap, n_ids.data_ptr(), 8 * n_sms,
                                  torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"sm_probe launch failed: CUDA error {err}")
            ids = tuple(int(i) for i in torch.nonzero(seen).flatten().tolist())
        if len(ids) != n_sms:
            raise RuntimeError(f"probe reached {len(ids)} of {n_sms} SMs")
        _SM_IDS[index] = ids
    return ids


def _band_table(device: torch.device, n_bands: int) -> torch.Tensor:
    """int32 table: %smid -> band of that SM, -1 for SMs not allocated."""
    index = device.index
    table = _BAND_TABLES.get((index, n_bands))
    if table is None:
        ids = sm_ids(device)
        host = torch.full((max(ids) + 1,), -1, dtype=torch.int32)
        for band, sm in enumerate(ids[:n_bands]):
            host[sm] = band
        table = host.to(device)
        _BAND_TABLES[(index, n_bands)] = table
    return table


def _launch(x: torch.Tensor, w: torch.Tensor, n_bands: Optional[int],
            traced: bool) -> tuple[torch.Tensor, Optional[TileTrace]]:
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError("persistent_matmul needs x and w on one CUDA device")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"persistent_matmul takes float32 or bfloat16, got {x.dtype}/{w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("persistent_matmul needs contiguous x and w")
    m, k = x.shape
    n = w.shape[1]
    if max(m * k, k * n, m * n) >= 2 ** 31:
        raise ValueError("persistent_matmul indexes rows with 32-bit ints")
    dev = x.device
    ids = sm_ids(dev)
    n_bands = len(ids) if n_bands is None else n_bands
    if not 1 <= n_bands <= len(ids):
        raise ValueError(f"n_bands={n_bands} outside 1..{len(ids)} SMs")
    bm, n_tiles_n, total, per_lane = tile_grid(m, n, n_bands)
    table = _band_table(dev, n_bands)
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    counters = torch.empty(n_bands + 1, dtype=torch.int32, device=dev)  # lanes, tiles done
    tile_sm = tile_hits = None
    if traced:
        tile_sm = torch.full((total,), -1, dtype=torch.int32, device=dev)
        tile_hits = torch.zeros(total, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().pinned_matmul(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, _DTYPES[x.dtype], bm,
            table.data_ptr(), table.numel(), n_bands, per_lane, n_tiles_n, total,
            counters.data_ptr(),
            None if tile_sm is None else tile_sm.data_ptr(),
            None if tile_hits is None else tile_hits.data_ptr(),
            int(n % 8 == 0 and k % 8 == 0 and x.data_ptr() % 16 == 0
                and w.data_ptr() % 16 == 0),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"persistent_matmul launch failed: CUDA error {err}")
    persistent_matmul.launches += 1
    if not traced:
        return out, None
    trace = TileTrace(tile_sm, tile_hits, int(counters[n_bands].item()),
                      tuple(ids[:n_bands]))
    return out, trace


def persistent_matmul(x: torch.Tensor, w: torch.Tensor,
                      n_bands: Optional[int] = None) -> torch.Tensor:
    """x [M, K] @ w [K, N] on the card's first ``n_bands`` SMs (all if None),
    two interleaved lanes per SM, float32 accumulation, output in x.dtype."""
    return _launch(x, w, n_bands, traced=False)[0]


persistent_matmul.launches = 0


def persistent_matmul_traced(x: torch.Tensor, w: torch.Tensor,
                             n_bands: Optional[int] = None):
    """As :func:`persistent_matmul`, also returning a :class:`TileTrace`
    (synchronises to read the finished-tile count)."""
    return _launch(x, w, n_bands, traced=True)
