"""Multi-segment self-suspension workload functions (paper Lemmas 2.1, 5.2, 5.4).

The paper analyses the same task three times from three resource viewpoints:
the bus (memory copies are execution, CPU+GPU are suspension — Lemma 5.2),
the uniprocessor (CPU segments are execution — Lemma 5.4), and, for the
self-suspension baseline, the CPU with *opaque* suspensions (Lemma 2.1).

All three are the same object: a :class:`ResourceView` with

  ``exec_hi[j]``    upper bound of the j-th execution segment (L̂),
  ``gap_lo[j]``     minimum suspension between exec j and j+1 inside a job
                    (sum of lower response bounds of the in-between segments),
  ``first_wrap``    min inter-arrival between the FIRST job's last exec
                    segment and the next job's first (T − D + tail + head),
  ``steady_wrap``   min inter-arrival between any later job's last exec
                    segment and the next (T − Σ exec_hi − Σ gap_lo).

Those four pieces reproduce exactly the paper's case analyses for
``S_i(j)`` / ``MS_i(j)`` / ``CS_i(j)``; see tests/test_core_rta.py for
literal cross-checks against the printed formulas.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Sequence

import numpy as np

from .task import RTTask, SegmentKind

__all__ = [
    "ResourceView",
    "StaircaseArrays",
    "ViewTables",
    "cpu_view",
    "mem_view",
    "gpu_view",
    "suspension_oblivious_view",
    "workload_fn",
    "max_workload",
]

_INF = math.inf


@dataclasses.dataclass(frozen=True)
class ResourceView:
    """One task as seen from one serial resource (execution vs suspension)."""

    exec_hi: tuple[float, ...]
    gap_lo: tuple[float, ...]  # len(exec_hi) - 1 interior gaps
    first_wrap: float
    steady_wrap: float
    period: float

    def __post_init__(self) -> None:
        if len(self.gap_lo) != len(self.exec_hi) - 1:
            raise ValueError("need K-1 interior gaps for K execution segments")

    @property
    def k(self) -> int:
        return len(self.exec_hi)

    def inter_arrival(self, j: int) -> float:
        """The paper's S_i(j)/MS_i(j)/CS_i(j): min gap after absolute exec j."""
        k = self.k
        if j % k != k - 1:
            return self.gap_lo[j % k]
        if j == k - 1:  # last exec segment of the *first* job in the window
            return self.first_wrap
        return self.steady_wrap


def _lo_response(task: RTTask, kind: SegmentKind, idx: int, n_vsm: int) -> float:
    """Lower response bound of one segment — CL̆ / ML̆ / GR̆ (Lemma 5.1)."""
    if kind is SegmentKind.CPU:
        return task.cpu_lo[idx]
    if kind is SegmentKind.MEM:
        return task.mem_lo[idx]
    lo, _ = task.gpu[idx].response_bounds(n_vsm)
    return lo


def _build_view(
    task: RTTask, res: SegmentKind, n_vsm: int, exec_pad: float = 0.0
) -> ResourceView:
    """Generic construction of the three paper case-analyses (DESIGN.md §5.2).

    ``exec_pad`` inflates every execution-segment upper bound by a constant
    (the preemptive-GPU view charges one context-switch overhead per kernel
    occurrence this way — see :func:`gpu_view`)."""
    chain = task.chain()
    exec_hi: list[float] = []
    gaps: list[float] = []
    cur_gap = 0.0
    head = 0.0  # lower-bound time before the first exec segment of a job
    seen_first = False
    for kind, idx in chain:
        if kind is res:
            if seen_first:
                gaps.append(cur_gap)
            seen_first = True
            cur_gap = 0.0
            if res is SegmentKind.CPU:
                ln = task.cpu_hi[idx]
            elif res is SegmentKind.MEM:
                ln = task.mem_hi[idx]
            else:
                _, ln = task.gpu[idx].response_bounds(n_vsm)
            exec_hi.append(ln + exec_pad)
        else:
            lo = _lo_response(task, kind, idx, n_vsm)
            if seen_first:
                cur_gap += lo
            else:
                head += lo
    tail = cur_gap  # lower-bound time after the last exec segment
    if not exec_hi:
        raise ValueError(f"task has no {res} segments")
    # Paper case analyses (Lemmas 2.1 / 5.2 / 5.4):
    #   first job's last exec segment -> everything delayed toward D, then
    #   T - D plus the minimum tail of this job and head of the next;
    #   steady state -> T minus the exec-hi / interior-gap-lo span only
    #   (the printed formulas keep head/tail OUT of the steady case: e.g.
    #   MS subtracts CL_1..CL_{m-2} but not CL_0, CL_{m-1}).
    first_wrap = max(0.0, task.period - task.deadline + tail + head)
    steady_wrap = max(0.0, task.period - sum(exec_hi) - sum(gaps))
    return ResourceView(
        exec_hi=tuple(exec_hi),
        gap_lo=tuple(gaps),
        first_wrap=first_wrap,
        steady_wrap=steady_wrap,
        period=task.period,
    )


def cpu_view(task: RTTask, n_vsm: int) -> ResourceView:
    """Lemma 5.4: CPU segments are execution; copies+GPU are suspension."""
    return _build_view(task, SegmentKind.CPU, n_vsm)


def mem_view(task: RTTask, n_vsm: int) -> ResourceView:
    """Lemma 5.2: memory copies are execution; CPU+GPU are suspension."""
    return _build_view(task, SegmentKind.MEM, n_vsm)


def gpu_view(task: RTTask, n_vsm: int, ctx: float = 0.0) -> ResourceView:
    """Preemptive-GPU occupancy view (GCAPS-style, beyond-paper).

    Under priority-driven GPU arbitration the accelerator is one serial,
    *preemptive* execution context per host: GPU segments are execution
    (their dedicated Lemma-5.1 upper response bound ``GR̂`` on the task's
    own ``n_vsm`` interleave lanes — occupancy while the kernel actually
    holds the GPU), CPU + memory-copy segments are suspension.  Each kernel
    occurrence is inflated by ``ctx``, the context-switch overhead: one
    higher-priority kernel arrival causes at most one preemption somewhere
    below it, so charging the switch cost to the *preemptor's* staircase
    contribution jointly covers every resume penalty the runtime bills to
    preempted kernels (see ``repro_torch.runtime.engine``)."""
    return _build_view(task, SegmentKind.GPU, n_vsm, exec_pad=ctx)


def suspension_oblivious_view(task: RTTask, n_vsm: int) -> ResourceView:
    """Baseline [47]: CPU exec segments with *opaque* mem+GPU suspensions.

    Identical gap structure to :func:`cpu_view` — the baseline's pessimism
    enters through blocking (suspensions of other tasks treated as
    non-preemptive), handled in baselines.py, not through the view.
    """
    return _build_view(task, SegmentKind.CPU, n_vsm)


@dataclasses.dataclass(frozen=True)
class StaircaseArrays:
    """One view's workload staircase as flat ``(K, P)`` float arrays.

    Row ``h`` holds the :class:`ViewTables` prefix sums for the window
    starting at execution segment ``h``: ``cum_ls[h, p]`` is the cumulative
    L̂+S advance through window position ``p``, ``cum_l[h, p]`` the
    cumulative execution, ``length[h, p]`` the position's own L̂.  This is
    the exchange format of the batched analyzer (`repro_torch.core.rta_batch`):
    ``W^h(t)`` for a whole vector of ``t`` is one ``searchsorted`` per row.

    ``min_horizon`` is the smallest per-row precomputed horizon; every
    ``t < min_horizon`` is answerable from the arrays alone.  Unlike the
    ``3K+2``-position rows the scalar bisect path keeps, these arrays are
    built to cover an explicit caller horizon: a *low*-priority task's
    fixed point queries a high-priority view at windows up to its own
    deadline, which can span many of the view's periods.
    """

    cum_ls: np.ndarray   # (K, P) float64
    cum_l: np.ndarray    # (K, P) float64
    length: np.ndarray   # (K, P) float64
    min_horizon: float


class ViewTables:
    """Fast evaluation of max_h W^h(t) for one view.

    Precomputes, for every window start ``h`` and window position ``p``
    (absolute segment index ``j = h + p``), the execution length ``L[h, p]``
    and the combined advance ``L + S`` prefix sums.  ``P = 3K + 2`` positions
    suffice for any window ``t <= T``: the steady cycle advance is
    ``max(T, Σ exec + Σ gaps) >= T``, so at most the first cycle plus two
    more cycles can start inside the window.

    Evaluation is a bisect over the per-``h`` prefix rows — K is tiny
    (≤ the subtask count), so plain lists beat vectorization — plus an
    exact-``t`` result cache: fixed-point iterations across candidate
    allocations revisit the same windows constantly, and tables are shared
    across analyses via :class:`repro_torch.core.rta.AnalysisTables`, so the hit
    rate in the online scheduler's admission loop is high.
    """

    _CACHE_LIMIT = 8192

    def __init__(self, view: ResourceView):
        self.view = view
        k = view.k
        p = 3 * k + 2
        gaps = view.gap_lo + (0.0,)  # position k-1 gets a wrap term instead
        self._rows: list[tuple[list[float], list[float], list[float]]] = []
        min_horizon = _INF
        for h in range(k):
            length: list[float] = []
            cum_ls: list[float] = []
            cum_l: list[float] = []
            acc_ls = acc_l = 0.0
            for pos in range(p):
                j = h + pos
                jk = j % k
                ln = view.exec_hi[jk]
                if jk != k - 1:
                    s = gaps[jk]
                elif j == k - 1:
                    s = view.first_wrap
                else:
                    s = view.steady_wrap
                acc_ls += ln + s
                acc_l += ln
                length.append(ln)
                cum_ls.append(acc_ls)
                cum_l.append(acc_l)
            self._rows.append((cum_ls, cum_l, length))
            min_horizon = min(min_horizon, cum_ls[-1])
        self._min_horizon = min_horizon
        self._cache: dict[float, float] = {}
        self._arrays: StaircaseArrays | None = None
        self._lists: tuple | None = None
        self._lists_src: StaircaseArrays | None = None

    def as_lists(self, horizon: float = 0.0) -> tuple:
        """``(cum_ls, cum_l, length, min_horizon)`` rows as plain lists.

        The scalar continuation of the batched fixed point walks these with
        monotone per-row pointers; plain-list indexing beats NumPy scalar
        boxing by an order of magnitude there."""
        arr = self.as_arrays(horizon)
        if self._lists_src is not arr:
            self._lists = (
                arr.cum_ls.tolist(),
                arr.cum_l.tolist(),
                arr.length.tolist(),
                arr.min_horizon,
            )
            self._lists_src = arr
        return self._lists

    # Hard cap on positions per row when extending toward a horizon: a
    # degenerate zero-advance cycle would otherwise loop forever.  Beyond
    # the cap, min_horizon stays short and callers use the scalar fallback.
    _MAX_POSITIONS = 65_536

    def as_arrays(self, horizon: float = 0.0) -> StaircaseArrays:
        """The staircase compiled to dense arrays covering ``horizon``.

        Rows are extended (by continuing the exact ``workload_fn``
        accumulation) until every row's cumulative advance strictly exceeds
        ``horizon``, so any window ``t <= horizon`` is answerable by pure
        array lookups.  The largest build is cached; asking for a smaller
        horizon returns it unchanged, a larger one rebuilds once.
        """
        cached = self._arrays
        if cached is not None and (
            cached.min_horizon > horizon
            or cached.cum_ls.shape[1] >= self._MAX_POSITIONS
        ):
            return cached
        view = self.view
        k = view.k
        # Per-position (L̂, L̂+S) follows a k-periodic pattern; only the one
        # absolute position j == k-1 (the first job's last exec segment)
        # deviates, using first_wrap instead of steady_wrap.  A full cycle
        # advances by at least max(T, span) > 0, so the position count is
        # bounded by ~k * (horizon / T); cap it against pathological views.
        cyc_len = np.asarray(view.exec_hi, dtype=np.float64)
        cyc_s = np.asarray(view.gap_lo + (view.steady_wrap,), dtype=np.float64)
        cyc_adv = cyc_len + cyc_s
        cycle_advance = float(cyc_adv.sum())
        need = 3 * k + 2
        if cycle_advance > 0.0:
            extra = horizon + view.first_wrap + view.steady_wrap + cycle_advance
            need = max(need, int(extra / cycle_advance + 2) * k)
        p = min(need, self._MAX_POSITIONS)
        # absolute segment index per (row h, position): j = h + pos
        j = np.arange(k)[:, None] + np.arange(p)[None, :]
        length = cyc_len[j % k]
        adv = cyc_adv[j % k]
        adv[j == k - 1] = view.exec_hi[k - 1] + view.first_wrap
        # np.add.accumulate emits every partial sum sequentially, so the
        # prefix rows are bit-identical to the workload_fn recurrence.
        cum_ls = np.add.accumulate(adv, axis=1)
        cum_l = np.add.accumulate(length, axis=1)
        self._arrays = StaircaseArrays(
            cum_ls=cum_ls,
            cum_l=cum_l,
            length=length,
            min_horizon=float(cum_ls[:, -1].min()),
        )
        return self._arrays

    def max_workload(self, t: float) -> float:
        """max_h W^h(t) over all window starts (bisect per row, cached)."""
        if t <= 0.0:
            return 0.0
        cached = self._cache.get(t)
        if cached is not None:
            return cached
        rows = self._rows
        if t >= self._min_horizon:
            # Window reaches past the ~2-period rows the constructor builds
            # (a LOW-priority task's fixed point queries this view at
            # windows up to its own deadline, i.e. many of our periods).
            # If the batched analyzer already compiled horizon-extended
            # arrays (as_arrays), bisect those — bit-identical to the
            # step-by-step recurrence; else fall back to workload_fn.
            arr = self._arrays
            if arr is not None and t < arr.min_horizon:
                rows = zip(arr.cum_ls, arr.cum_l, arr.length)
            else:
                rows = None
        if rows is None:
            out = max(
                workload_fn(self.view, h, t) for h in range(self.view.k)
            )
        else:
            out = 0.0
            for cum_ls, cum_l, length in rows:
                nfull = bisect.bisect_right(cum_ls, t)
                if nfull:
                    consumed = cum_ls[nfull - 1]
                    work = cum_l[nfull - 1]
                else:
                    consumed = work = 0.0
                partial = min(length[nfull], t - consumed)
                if partial > 0.0:
                    work += partial
                if work > out:
                    out = work
        if len(self._cache) >= self._CACHE_LIMIT:
            # Drop only the oldest half (dicts preserve insertion order) so
            # the windows a fixed point is actively revisiting survive
            # eviction mid-iteration.
            for key in list(self._cache)[: self._CACHE_LIMIT // 2]:
                del self._cache[key]
        self._cache[t] = out
        return out


def tables(view: ResourceView) -> "ViewTables":
    return ViewTables(view)


def workload_fn(view: ResourceView, h: int, t: float, max_iters: int = 100_000) -> float:
    """W_i^h(t) — max execution a task performs in a window of length t that
    starts with execution segment ``h`` (Lemma 2.1 / 5.2 / 5.4).
    """
    if t <= 0.0:
        return 0.0
    k = view.k
    acc = 0.0  # Σ_{j=h}^{cur-1} (L̂ + S)
    work = 0.0
    j = h
    for _ in range(max_iters):
        length = view.exec_hi[j % k]
        s = view.inter_arrival(j)
        if acc + length + s <= t:
            work += length
            acc += length + s
            j += 1
        else:
            return work + min(length, t - acc)
    return _INF  # degenerate view (all-zero cycle): maximally conservative


def max_workload(view: ResourceView, t: float) -> float:
    """max_{h in [0, K-1]} W_i^h(t) — the interference bound used in the
    response-time recurrences (Lemmas 2.2, 5.3, 5.5).
    """
    return max(workload_fn(view, h, t) for h in range(view.k))


def view_hyperperiod_guard(views: Sequence[ResourceView]) -> float:
    """A conservative iteration horizon for fixed points (max deadline-scale)."""
    return max(v.period for v in views)
