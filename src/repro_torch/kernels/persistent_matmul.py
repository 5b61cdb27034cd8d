"""Persistent matmul pinned to SMs — the paper's Algorithm 1 on the H100.

Replaces the Pallas TPU kernel ``repro/kernels/persistent_matmul.py``
(``persistent_matmul``; ``_kernel`` and ``tile_of``).  The kernel is
``csrc/persistent_matmul.cu``: persistent CTAs read ``%smid`` and return
unless their SM is one of the task's ``n_bands`` SMs; on each allocated SM
two CTAs claim lanes 0 and 1 (the self-interleaved halves) and walk
``tile_of``'s map over the launch's work units.  The variant follows from
the shape and type alone (``kernel_name``): a streaming decode kernel for
M <= 4, a TMA-fed ``wgmma`` kernel with 128 x 128 tiles for the bf16
prefill shapes whose rows TMA can stride (K and N multiples of 8),
``mma.sync`` tiles for the other bf16 shapes and CUDA-core tiles for
float32 and 4 < M <= 16.  See the source for what bounds each variant and
why.

A work unit is (row tile, col tile, K slice).  Where the output tiles are
too few to fill the card, K is split into slices (``split_plan``, a
function of the shape alone, so results stay bit-identical for every band
count); each unit writes a float32 partial to a workspace, and the last
unit of a tile to arrive sums the partials in slice order.

The allocated SMs are ``n_bands`` consecutive SM ids of those the card
reports, from the ``first_sm``-th on (0 by default), found once per device
by a probe kernel (SM ids need not be contiguous).  Tasks given disjoint
ranges run their matmuls on disjoint SMs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch import roofline

from . import _build

__all__ = ["TileTrace", "TracePool", "Grid", "tile_shape", "kernel_name", "stage_rows", "split_plan",
           "tile_grid", "unit_of", "tile_of", "sm_ids", "persistent_matmul",
           "persistent_matmul_traced"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int

# A whole H100 is 132 SMs of two lanes.  A constant: the split plan may
# depend on the shape alone, never on the card or on n_bands, or results
# would differ between band counts.
FILL_LANES = 2 * 132
BLOCK_K = 32          # K step of the register-staged tiled variants
WGMMA_TILE = 128      # rows and columns of a wgmma tile
WGMMA_K = 64          # its K step: 64 bf16, one 128-byte swizzle row
# A split wgmma unit writes a 64 KB float32 partial that the tile's last
# unit reads back: on the H100 that costs about as much as 4 K rows of the
# products per unit of the launch (fitted to scripts/wgmma_split_sweep.py)
WGMMA_PARTIAL_ROWS = 4
GEMV_ROW_BYTES = 512   # a decode unit's segment of each weight row
STAGE_BYTES = 16384   # weights per stage of the decode variant's ring
MAX_STAGE_ROWS = 128  # K rows per stage, at most (the x stage holds 4 x 128)


def tile_shape(m: int, k: int, n: int, itemsize: int) -> tuple[int, int]:
    """(rows, cols) of an output tile, which names the variant: the decode
    variant takes 4 rows and 512 bytes of each weight row (256 bf16 or 128
    float32 columns) for M <= 4; the wgmma variant 128 x 128 for bf16 with
    M > 16 where TMA can stride the rows (K % 8 == 0, N % 8 == 0); the
    register-staged tiled variants 16 x 64 or 64 x 64."""
    if m <= 4:
        return 4, GEMV_ROW_BYTES // itemsize
    if m <= 16:
        return 16, 64
    if itemsize == 2 and k % 8 == 0 and n % 8 == 0:
        return WGMMA_TILE, WGMMA_TILE
    return 64, 64


def kernel_name(m: int, k: int, n: int, dtype: torch.dtype) -> str:
    """The CUDA kernel that an [m, k] @ [k, n] launch in ``dtype`` runs."""
    bm, _ = tile_shape(m, k, n, dtype.itemsize)
    if bm == 4:
        return "pinned_gemv_kernel"
    if bm == WGMMA_TILE:
        return "pinned_wgmma_kernel"
    return "pinned_mma_kernel" if bm == 64 and dtype == torch.bfloat16 else "pinned_matmul_kernel"


def stage_rows(n: int, itemsize: int) -> int:
    """K rows per stage of the decode variant: 16 KB of weights.  Where one
    unit spans all of N (rows of 512 bytes or less) a stage is one
    contiguous slab of the weights, stage_rows * N elements; else 512 bytes
    of each row."""
    if n * itemsize <= GEMV_ROW_BYTES:
        return min(MAX_STAGE_ROWS, STAGE_BYTES // (n * itemsize) // 8 * 8)
    return STAGE_BYTES // GEMV_ROW_BYTES


@dataclasses.dataclass(frozen=True)
class Grid:
    """One launch's work units.  The linear unit index is
    tile * n_slices + slice (``unit_of``); lanes walk it by ``tile_of``'s
    map, per_lane units each."""
    block_m: int
    block_n: int
    n_tiles_n: int
    tiles: int
    n_slices: int
    slice_len: int   # a multiple of k_step; the last slice is ragged
    k_step: int      # the variant's K step: a decode stage, WGMMA_K or BLOCK_K
    per_lane: int

    @property
    def units(self) -> int:
        return self.tiles * self.n_slices


@functools.lru_cache(maxsize=None)
def split_plan(m: int, k: int, n: int, itemsize: int) -> tuple[int, int, int]:
    """(n_slices, slice_len, k_step) for an [m, k] @ [k, n] product.

    A function of the shape and type alone.  Where the (row, col) tiles
    fill the card's FILL_LANES lanes, or for the 4 < M <= 16 variant, K is
    not split.  Otherwise the slice length (a multiple of the K step) is
    the one that minimises a lane's time, estimated as units per lane
    times (slice length + a fixed cost per unit): more slices fill more
    lanes, and each unit costs a reduction.  The wgmma variant's 128 x 128
    partials are costed by their traffic instead: each unit of a split
    launch adds WGMMA_PARTIAL_ROWS K rows to every lane's time."""
    bm, bn = tile_shape(m, k, n, itemsize)
    tiles = -(-m // bm) * -(-n // bn)
    partial_rows = 0
    if bm == 4:
        step = stage_rows(n, itemsize)
        unit_rows = step  # a unit's end costs about one stage
    elif bm == WGMMA_TILE:
        step, unit_rows, partial_rows = WGMMA_K, 0, WGMMA_PARTIAL_ROWS
    else:
        step, unit_rows = BLOCK_K, 4 * BLOCK_K
    steps = max(1, -(-k // step))
    if tiles >= FILL_LANES or bm == 16:
        return 1, steps * step, step
    best = None
    for q in range(steps, 0, -1):  # slice length in steps, longest first
        slices = -(-steps // q)
        cost = -(-tiles * slices // FILL_LANES) * (q * step + unit_rows)
        if slices > 1:
            cost += tiles * slices * partial_rows
        if best is None or cost < best[0]:
            best = (cost, slices, q * step)
    return best[1], best[2], step


def tile_grid(m: int, k: int, n: int, dtype: torch.dtype, n_bands: int) -> Grid:
    """The work units of one [m, k] @ [k, n] launch on ``n_bands`` bands."""
    bm, bn = tile_shape(m, k, n, dtype.itemsize)
    n_tiles_n = -(-n // bn)
    tiles = -(-m // bm) * n_tiles_n
    n_slices, slice_len, step = split_plan(m, k, n, dtype.itemsize)
    per_lane = -(-tiles * n_slices // (2 * n_bands))
    return Grid(bm, bn, n_tiles_n, tiles, n_slices, slice_len, step, per_lane)


def unit_of(linear: int, n_tiles_n: int, n_slices: int) -> tuple[int, int, int]:
    """(row tile, col tile, K slice) of the linear unit index ``linear``."""
    tile, k_slice = divmod(linear, n_slices)
    return tile // n_tiles_n, tile % n_tiles_n, k_slice


def tile_of(band: int, lane: int, step: int, tiles_per_lane: int,
            n_tiles_n: int) -> tuple[int, int]:
    """(row tile, col tile) for this (band, interleave lane, step).

    Band b owns the contiguous tile range [b*2T, (b+1)*2T); its two lanes
    interleave that range round-robin (Alg. 1's two halves).  Tiles at or
    past the end are masked by the kernel.  The kernel walks its linear
    unit index by this map; with K split, ``unit_of`` names the unit."""
    linear = band * (2 * tiles_per_lane) + step * 2 + lane
    return linear // n_tiles_n, linear % n_tiles_n


@dataclasses.dataclass(frozen=True)
class TileTrace:
    """What a traced launch saw: for each work unit the SM that computed it
    and how many times it was computed, plus the kernel's finished-unit
    count.  The tensors stay on the card, so a traced launch does not wait
    for the kernel; reading ``tiles_done`` synchronises."""
    tile_sm: torch.Tensor     # [units] int32, -1 if never computed
    tile_hits: torch.Tensor   # [units] int32
    done: torch.Tensor        # [1] int32, the finished-unit count
    allowed_sms: tuple[int, ...]

    @property
    def tiles_done(self) -> int:
        return int(self.done.item())


class TracePool:
    """Trace buffers for many traced launches, initialised once on the
    card: each launch takes the next ``units`` entries as views, with no
    allocation and no fill of its own, so tracing a whole job adds little
    host time to it."""

    def __init__(self, units: int, device):
        self.tile_sm = torch.full((units,), -1, dtype=torch.int32, device=device)
        self.tile_hits = torch.zeros(units, dtype=torch.int32, device=device)
        self.used = 0

    def take(self, units: int) -> tuple[torch.Tensor, torch.Tensor]:
        a, self.used = self.used, self.used + units
        if self.used > self.tile_sm.numel():
            raise RuntimeError(f"trace pool of {self.tile_sm.numel()} units exhausted")
        return self.tile_sm[a:self.used], self.tile_hits[a:self.used]


_SM_IDS: dict[int, tuple[int, ...]] = {}
_BAND_TABLES: dict[tuple[int, int, int], torch.Tensor] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("persistent_matmul")
    lib.pinned_matmul.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _P, _P, _P, _P, _I, _I, _P]
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


def _band_table(device: torch.device, first_sm: int, n_bands: int) -> torch.Tensor:
    """int32 table: %smid -> band of that SM, -1 for SMs not allocated."""
    index = device.index
    table = _BAND_TABLES.get((index, first_sm, n_bands))
    if table is None:
        ids = sm_ids(device)
        host = torch.full((max(ids) + 1,), -1, dtype=torch.int32)
        for band, sm in enumerate(ids[first_sm:first_sm + n_bands]):
            host[sm] = band
        table = host.to(device)
        _BAND_TABLES[(index, first_sm, n_bands)] = table
    return table


def _launch(x: torch.Tensor, w: torch.Tensor, n_bands: Optional[int], first_sm: int,
            traced: bool, pool: Optional[TracePool] = None
            ) -> tuple[torch.Tensor, Optional[TileTrace]]:
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
    n_bands = len(ids) - first_sm if n_bands is None else n_bands
    if first_sm < 0 or n_bands < 1 or first_sm + n_bands > len(ids):
        raise ValueError(f"SMs {first_sm}..{first_sm + n_bands - 1} outside the card's "
                         f"0..{len(ids) - 1}")
    g = tile_grid(m, k, n, x.dtype, n_bands)
    if g.block_m == WGMMA_TILE:
        # TMA reads from 16-byte aligned bases: a misaligned operand is
        # copied, never sent to another variant
        x = x if x.data_ptr() % 16 == 0 else x.clone()
        w = w if w.data_ptr() % 16 == 0 else w.clone()
    table = _band_table(dev, first_sm, n_bands)
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    split = g.n_slices > 1
    # lane counters, the finished-unit count, then one arrival count per tile
    counters = torch.empty(n_bands + 1 + (g.tiles if split else 0), dtype=torch.int32,
                           device=dev)
    ws = torch.empty((g.n_slices, m, n), dtype=torch.float32, device=dev) if split else None
    tile_sm = tile_hits = None
    if traced:
        tile_sm, tile_hits = (pool or TracePool(g.units, dev)).take(g.units)
    # 16-byte aligned rows: x's when K % 8 == 0; w's when N % 8 == 0, or, where
    # one decode unit spans N, every slab of w when K % 8 == 0
    vec_x = k % 8 == 0 and x.data_ptr() % 16 == 0
    vec_w = (n % 8 == 0 or (g.block_m == 4 and n <= g.block_n and k % 8 == 0)) \
        and w.data_ptr() % 16 == 0
    with torch.cuda.device(dev):
        err = _lib().pinned_matmul(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, _DTYPES[x.dtype], g.block_m,
            table.data_ptr(), table.numel(), n_bands, g.per_lane, g.n_tiles_n, g.tiles,
            g.n_slices, g.slice_len, g.k_step, counters.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if tile_sm is None else tile_sm.data_ptr(),
            None if tile_hits is None else tile_hits.data_ptr(),
            int(vec_x), int(vec_w), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"persistent_matmul launch failed: CUDA error {err}")
    persistent_matmul.launches += 1
    if not traced:
        return out, None
    trace = TileTrace(tile_sm, tile_hits, counters[n_bands:n_bands + 1],
                      tuple(ids[first_sm:first_sm + n_bands]))
    return out, trace


def persistent_matmul(x: torch.Tensor, w: torch.Tensor,
                      n_bands: Optional[int] = None, first_sm: int = 0) -> torch.Tensor:
    """x [M, K] @ w [K, N] on ``n_bands`` of the card's SMs from the
    ``first_sm``-th on (all the rest if None), two interleaved lanes per SM,
    float32 accumulation, output in x.dtype.  On the meta device (the dry
    run's): an empty [M, N], its 2 M K N FLOPs and bytes counted by the
    active ``roofline.analyze_step``; nothing launches."""
    if x.device.type == "meta":
        (m, k), n = x.shape, w.shape[1]
        out = torch.empty((m, n), dtype=x.dtype, device="meta")
        roofline.record_kernel(2 * m * k * n, (x, w), (out,), product=(w, 0))
        return out
    return _launch(x, w, n_bands, first_sm, traced=False)[0]


persistent_matmul.launches = 0


def persistent_matmul_traced(x: torch.Tensor, w: torch.Tensor,
                             n_bands: Optional[int] = None, first_sm: int = 0,
                             pool: Optional[TracePool] = None):
    """As :func:`persistent_matmul`, also returning a :class:`TileTrace`
    over work units (its buffers taken from ``pool``, by default a pool of
    this launch alone)."""
    return _launch(x, w, n_bands, first_sm, traced=True, pool=pool)
