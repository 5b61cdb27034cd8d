"""Fig. 6's interleave ratio α measured on the card.

Replaces no TPU kernel: the probes of ``csrc/interleave_probe.cu`` are a
measuring tool, the card's counterpart of the host timing in
``benchmarks/fig6_interleave.py`` (``_workloads``: compute, memory, branch
and special).  A probe runs pinned by ``%smid`` to ``n_sms`` of the card's
SMs, as the pinned matmul is (``persistent_matmul.sm_ids``, the same band
table), with one lane per SM, then with two co-resident lanes per SM that
do the same work each.  α is a lane's time with two on its SM over its
time alone, each lane timed by ``%globaltimer`` stamps in the kernel: the
paper's latency-extension ratio (§4.3), which Lemma 5.1's GR̂ takes per
kernel type.  On the card only: there is no plain version, since what is
measured is the card itself.
"""
from __future__ import annotations

import ctypes
import functools
import statistics

import torch

from . import _build
from .persistent_matmul import _band_table, sm_ids

__all__ = ["KINDS", "ITERS", "MEMORY_FLOATS", "REPS", "measure_alpha", "probe"]

KINDS = ("compute", "memory", "branch", "special")
# work per lane: about 0.1-0.5 ms alone on an H100 SM at 1980 MHz
ITERS = {"compute": 64, "memory": 1, "branch": 2048, "special": 2048}
MEMORY_FLOATS = 1 << 20   # the memory probe's slice per lane: 4 MB read, 4 MB written
REPS = 5                  # launches of each arrangement; the median lane time is kept
_THREADS = 256
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_BUFFERS: dict[tuple[int, int], torch.Tensor] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("interleave_probe")
    lib.interleave_probe.argtypes = [_I, _P, _I, _I, _I, _I, _P, _L, _I, _P, _P, _P]
    lib.interleave_probe.restype = _I
    return lib


def _buffer(device: torch.device, slots: int) -> torch.Tensor:
    """2 * MEMORY_FLOATS floats per lane slot, zeroed once per device."""
    key = (device.index, slots)
    buf = _BUFFERS.get(key)
    if buf is None:
        buf = _BUFFERS[key] = torch.zeros(slots * 2 * MEMORY_FLOATS, dtype=torch.float32,
                                          device=device)
    return buf


def probe(kind: str, n_sms: int, lanes: int, first_sm: int = 0, device=None) -> dict:
    """One launch of ``kind``'s probe on ``n_sms`` SMs from the
    ``first_sm``-th, ``lanes`` (1 or 2) working lanes on each: each lane's
    time in µs (band-major, lane-minor) and, with two lanes, the share of
    each SM's shorter lane that overlapped the other."""
    if kind not in KINDS:
        raise ValueError(f"kernel type {kind!r} not in {KINDS}")
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError("the interleave probes run on the card only")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ids = sm_ids(device)
    if first_sm < 0 or n_sms < 1 or first_sm + n_sms > len(ids) or lanes not in (1, 2):
        raise ValueError(f"{lanes} lanes on SMs {first_sm}..{first_sm + n_sms - 1} of "
                         f"0..{len(ids) - 1}")
    table = _band_table(device, first_sm, n_sms)
    buf = _buffer(device, 2 * len(ids))
    counters = torch.empty(n_sms + 1, dtype=torch.int32, device=device)
    stamps = torch.empty(4 * n_sms, dtype=torch.int64, device=device)
    # 7 CTAs of 32 KB shared memory fit an SM: 16 a probed SM puts at least two
    # in the first wave wherever the scheduler spreads them
    grid = 16 * len(ids)
    with torch.cuda.device(device):
        err = _lib().interleave_probe(
            KINDS.index(kind), table.data_ptr(), table.numel(), n_sms, lanes, grid,
            buf.data_ptr(), MEMORY_FLOATS, ITERS[kind], counters.data_ptr(), stamps.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"interleave_probe launch failed: CUDA error {err}")
    ran = int(counters[n_sms].item())
    if ran != lanes * n_sms:
        raise RuntimeError(f"{kind} probe: {ran} lanes ran, {lanes} on each of {n_sms} SMs asked")
    st = stamps.view(n_sms, 2, 2).cpu().tolist()
    lane_us = [(e - s) / 1e3 for band in st for s, e in band[:lanes]]
    out = {"lane_us": lane_us}
    if lanes == 2:
        out["overlap"] = [max(0, min(a[1], b[1]) - max(a[0], b[0]))
                          / max(1, min(a[1] - a[0], b[1] - b[0])) for a, b in st]
    return out


def measure_alpha(kind: str, n_sms: int, first_sm: int = 0, reps: int = REPS,
                  device=None) -> dict:
    """α of ``kind`` on ``n_sms`` SMs: the median over ``reps`` launches of
    the mean lane time with two co-resident lanes per SM, over the same
    with one lane per SM (after an untimed launch of each).  Also each
    arrangement's median lane time (µs), the makespan ratio (the same with
    the slowest lane of each launch: where the two lanes of an SM share
    its units unevenly, the later one finishes past α times its time
    alone) and the least overlap of two lanes on one SM (1 = wholly
    co-resident)."""
    for lanes in (1, 2):
        probe(kind, n_sms, lanes, first_sm, device)
    alone, both, overlap = [], [], 1.0
    for _ in range(reps):
        one = probe(kind, n_sms, 1, first_sm, device)
        two = probe(kind, n_sms, 2, first_sm, device)
        alone.append((statistics.fmean(one["lane_us"]), max(one["lane_us"])))
        both.append((statistics.fmean(two["lane_us"]), max(two["lane_us"])))
        overlap = min(overlap, min(two["overlap"]))
    alone_us, both_us = (statistics.median(t for t, _ in x) for x in (alone, both))
    makespan = statistics.median(t for _, t in both) / statistics.median(t for _, t in alone)
    return {"alpha": both_us / alone_us, "alone_us": alone_us, "both_us": both_us,
            "makespan_alpha": makespan, "overlap": overlap}
