"""Frontier-batched vectorized RTGPU schedulability analysis.

The scalar path (``repro_torch.core.rta``) evaluates one candidate allocation at
a time: every Lemma 5.3/5.5 fixed point is a Python closure over
``ViewTables.max_workload``.  Admission cost therefore scales linearly with
candidates tried — the dominant cost of ``DynamicController.admit`` and of
acceptance-ratio sweeps.

This module evaluates the same recurrences for an entire **frontier of
candidate allocation prefixes at once**:

  * each ``ResourceView`` staircase is compiled to flat ``(K, P)`` arrays
    (:meth:`repro_torch.core.workload.ViewTables.as_arrays`) — ``W^h(t)`` for a
    vector of windows is one ``searchsorted`` per row;
  * the Lemma 5.3 (bus) / Lemma 5.5 (CPU) / Theorem 5.6 fixed points run
    in lockstep over all candidates, freezing entries as they converge;
  * :func:`grid_search_frontier` replaces the node-at-a-time DFS with a
    breadth-wise search: expand all surviving prefixes at depth k, analyze
    them in ONE batched call, prune, descend.  Candidates are kept in the
    paper's lexicographic order (hint order when warm-started), so the
    first full-depth success is the *same allocation* the DFS returns.

Exactness contract: on the NumPy backend every sum is accumulated in the
same order as the scalar path, so verdicts, allocations and R̂ values are
bit-identical (tests/test_rta_batch.py asserts this; the optional JAX
backend — see ``repro_torch.core.backend`` — is held to 1e-9).

One batching dividend the scalar DFS cannot exploit: siblings (children of
one frontier prefix) share all higher-priority interference, so the per-
copy bus/CPU fixed points are computed once per *parent* and only the
Theorem 5.6 combination (which depends on the candidate's own GN) runs per
*child*.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.obs import metrics

from .backend import get_backend
from .rta import (
    AnalysisTables,
    PreemptionModel,
    RtgpuIncremental,
    SetAnalysis,
    TaskAnalysis,
)
from .task import TaskSet
from .workload import ViewTables, workload_fn

__all__ = ["BatchAnalyzer", "DepthAnalysis", "grid_search_frontier"]

_INF = math.inf
_EPS = 1e-9          # fixed-point convergence tolerance (matches rta._EPS)
_MAX_ITERS = 10_000  # matches rta.fixed_point
_FINAL_CHUNK = 2048  # final-depth candidates analyzed per early-exit chunk
_HYBRID_TABLE_LIMIT = 50_000  # pairs-rows x windows above which per-variant eval wins


# ---- staircase evaluation ---------------------------------------------------


def _eval_staircase(vt: ViewTables, t: np.ndarray, arr=None) -> np.ndarray:
    """``max_h W^h(t)`` for a vector of windows — exact scalar-path match.

    Duplicate windows (ubiquitous once a batch of fixed points starts
    converging) are collapsed before touching the arrays.
    """
    if arr is None:
        arr = vt.as_arrays()
    if t.size > 16:
        tu, inv = np.unique(t, return_inverse=True)
    else:
        tu, inv = t, None
    out = np.zeros_like(tu)
    pos = tu > 0.0
    far = pos & (tu >= arr.min_horizon)
    near = pos & ~far
    if near.any():
        tm = tu[near]
        cum_ls = arr.cum_ls
        k, p = cum_ls.shape
        nfull = np.empty((k, tm.size), dtype=np.int64)
        for h in range(k):
            nfull[h] = cum_ls[h].searchsorted(tm, side="right")
        rowoff = np.arange(k)[:, None] * p
        at = rowoff + nfull
        have = nfull > 0
        idx = at - have  # == rowoff + (nfull-1 if have else nfull==0)
        consumed = np.where(have, cum_ls.ravel()[idx], 0.0)
        work = np.where(have, arr.cum_l.ravel()[idx], 0.0)
        partial = np.minimum(arr.length.ravel()[at], tm[None, :] - consumed)
        work = work + np.maximum(partial, 0.0)
        out[near] = work.max(axis=0)
    if far.any():
        # Beyond the precomputed horizon — only degenerate views whose rows
        # hit the position cap before covering it: defer to the scalar path.
        view = vt.view
        out[far] = [
            max(workload_fn(view, h, float(tv)) for h in range(view.k))
            for tv in tu[far]
        ]
    return out if inv is None else out[inv]


@dataclasses.dataclass
class _HpGroup:
    """One higher-priority view position: its tables per GN, and each
    candidate's GN at that position."""

    vt_by_gn: dict[int, ViewTables]
    gn_col: np.ndarray  # (B,) int


# ---- backends ---------------------------------------------------------------


@dataclasses.dataclass
class _PartStack:
    """All (view, GN) pairs of one interference part, stacked row-wise.

    ``G`` pairs contribute ``R`` staircase rows total, right-padded to a
    common ``P`` with ``cum_ls=inf`` / ``length=0`` sentinels that can
    never be counted as full positions.  One fused evaluation answers
    every pair at every unique window of an iteration.
    """

    cum_ls: np.ndarray       # (R, P)
    cum_l: np.ndarray        # (R, P)
    length: np.ndarray       # (R, P)
    pair_starts: np.ndarray  # (G,) first row of each pair
    minh: np.ndarray         # (G,) per-pair precomputed horizon
    refs: list               # (vt, arr) per pair — keeps ids stable + far path

    def eval(self, tu: np.ndarray) -> np.ndarray:
        """Workloads ``W[g, i] = max_h W^h(tu[i])`` for every pair ``g``.

        ``tu`` must be sorted unique (as produced by ``np.unique``); each
        per-row position count is recovered from one bulk ``searchsorted``
        against ``tu`` plus a bincount/cumsum, so cost is a handful of
        array ops regardless of how many pairs or rows are stacked.
        """
        r, p = self.cum_ls.shape
        n = tu.size
        # q[r,p] = #{tu < cum_ls[r,p]};  then nfull[r,i] = #{p: q[r,p] <= i}
        # reproduces bisect_right(cum_ls[r], tu[i]) with exact comparisons.
        q = np.searchsorted(tu, self.cum_ls.ravel(), side="left")
        np.minimum(q, n, out=q)
        keys = q + np.repeat(np.arange(r) * (n + 1), p)
        table = np.bincount(keys, minlength=r * (n + 1)).reshape(r, n + 1)
        nfull = table.cumsum(axis=1)[:, :n]
        np.minimum(nfull, p - 1, out=nfull)  # far rows get overwritten below
        have = nfull > 0
        rowoff = (np.arange(r) * p)[:, None]
        idx = rowoff + nfull - have
        consumed = np.where(have, self.cum_ls.ravel()[idx], 0.0)
        work = np.where(have, self.cum_l.ravel()[idx], 0.0)
        partial = np.minimum(
            self.length.ravel()[rowoff + nfull], tu[None, :] - consumed
        )
        work = work + np.maximum(partial, 0.0)
        out = np.maximum.reduceat(work, self.pair_starts, axis=0)
        nonpos = tu <= 0.0
        if nonpos.any():
            out[:, nonpos] = 0.0
        if tu[-1] >= self.minh.min():
            # beyond a pair's precomputed horizon (degenerate views whose
            # rows hit the position cap): defer to the scalar path
            for g, mh in enumerate(self.minh):
                far = ~nonpos & (tu >= mh)
                if far.any():
                    view = self.refs[g][0].view
                    out[g, far] = [
                        max(workload_fn(view, h, float(tv))
                            for h in range(view.k))
                        for tv in tu[far]
                    ]
        return out


def _build_stack(pairs: list[tuple]) -> _PartStack:
    """Stack a ``(ViewTables, StaircaseArrays)`` pair list row-wise."""
    pmax = max(arr.cum_ls.shape[1] for _vt, arr in pairs)
    starts, rows = [], 0
    for _vt, arr in pairs:
        starts.append(rows)
        rows += arr.cum_ls.shape[0]
    cum_ls = np.full((rows, pmax), _INF)
    cum_l = np.zeros((rows, pmax))
    length = np.zeros((rows, pmax))
    for (start, (_vt, arr)) in zip(starts, pairs):
        k, p = arr.cum_ls.shape
        cum_ls[start:start + k, :p] = arr.cum_ls
        cum_l[start:start + k, :p] = arr.cum_l
        length[start:start + k, :p] = arr.length
    return _PartStack(
        cum_ls=cum_ls,
        cum_l=cum_l,
        length=length,
        pair_starts=np.asarray(starts, dtype=np.int64),
        minh=np.array([arr.min_horizon for _vt, arr in pairs]),
        refs=pairs,
    )


class _NumpyEngine:
    """Lockstep batched fixed point; bit-identical to ``rta.fixed_point``.

    Per iteration, each part's interference is answered by ONE fused
    :meth:`_PartStack.eval` over the iteration's unique windows, then
    scattered back per higher-priority position in priority order (the
    exact association of the scalar closures).  The bulk of a batch
    converges within a few vectorized sweeps; the few slow-converging
    stragglers (iterates crawling toward the limit) are handed to a scalar
    continuation — same update rule, same floats, but per-iteration cost
    measured in dict lookups instead of array dispatch.
    """

    name = "numpy"

    # below this many active entries, scalar iteration beats NumPy dispatch
    _TAIL = 48
    # the fused-rows path hands off much later: its per-iteration cost
    # shrinks with the active set (few unique windows), while each scalar
    # continuation pays a per-row walker build — only true crawlers win
    _TAIL_ROWS = 8
    _STACK_CACHE_LIMIT = 256

    def __init__(self) -> None:
        self._stacks: dict[tuple, _PartStack] = {}

    def _cache_stack(self, key: tuple, pairs: list[tuple]) -> _PartStack:
        st = self._stacks.get(key)
        if st is not None:
            return st
        st = _build_stack(pairs)
        if len(self._stacks) >= self._STACK_CACHE_LIMIT:
            # Engine-global cache: it also pins the referenced ViewTables /
            # arrays of departed task sets, so evict the oldest half
            # (insertion order) rather than growing until process exit.
            for old in list(self._stacks)[: self._STACK_CACHE_LIMIT // 2]:
                del self._stacks[old]
        self._stacks[key] = st
        return st

    def _part_stack(self, groups, horizon: float) -> Optional[_PartStack]:
        """Build (or fetch) the stacked arrays for one part's pair set."""
        pairs: list[tuple] = []
        for grp in groups:
            for gval in sorted(grp.vt_by_gn):
                vt = grp.vt_by_gn[gval]
                pairs.append((vt, vt.as_arrays(horizon)))
        if not pairs:
            return None
        return self._cache_stack(
            tuple(id(arr) for _vt, arr in pairs), pairs
        )

    def rows_stack(self, pairs: list[tuple]) -> Optional[_PartStack]:
        """Build (or fetch) the stacked arrays for an explicit pair list
        (the fused-rows entry point); shares the part-stack cache."""
        if not pairs:
            return None
        return self._cache_stack(
            ("rows",) + tuple(id(arr) for _vt, arr in pairs), pairs
        )

    def fixed_point_batch(
        self,
        base: np.ndarray,          # (B, J)
        limit: float,
        parts: Sequence[Sequence[_HpGroup]],
        const: float,
        horizon: float = 0.0,
    ) -> np.ndarray:
        B, J = base.shape
        if B == 0 or J == 0:
            return np.zeros((B, J))
        metrics.inc("rta_batch_calls_total")
        # Per-call precomputation: one stacked array set per part, plus each
        # group's candidate-row -> pair-index column and per-variant masks.
        prep = []
        for groups in parts:
            st = self._part_stack(groups, horizon)
            cols = []
            pair_base = 0
            for grp in groups:
                uniq = np.array(sorted(grp.vt_by_gn), dtype=np.int64)
                cols.append(pair_base + np.searchsorted(uniq, grp.gn_col))
                pair_base += uniq.size
            variants = [
                [
                    (vt, vt.as_arrays(horizon), grp.gn_col == gval)
                    for gval, vt in sorted(grp.vt_by_gn.items())
                ]
                for grp in groups
            ]
            prep.append((st, cols, variants))
        res = np.full((B, J), _INF)
        active = base <= limit
        x = base.copy()
        for it in range(_MAX_ITERS):
            bi, ji = np.nonzero(active)
            if bi.size == 0:
                break
            if bi.size <= self._TAIL:
                # convergence stragglers handed to the scalar tail loop
                metrics.inc("rta_batch_stragglers_total", amount=bi.size)
                for b, j in zip(bi.tolist(), ji.tolist()):
                    res[b, j] = self._scalar_tail(
                        base[b, j], x[b, j], limit, parts, const, b,
                        _MAX_ITERS - it, horizon,
                    )
                break
            t = x[bi, ji]
            tu = inv = None
            # interference: per-part partial sums, each accumulated in
            # priority order — the exact association of the scalar closures
            acc = np.zeros_like(t)
            for st, cols, variants in prep:
                pacc = np.zeros_like(t)
                if st is not None and (
                    t.size * st.cum_ls.shape[0] <= _HYBRID_TABLE_LIMIT
                ):
                    # small batch: one fused counting-table evaluation of
                    # every pair at every unique window
                    if tu is None:
                        tu, inv = np.unique(t, return_inverse=True)
                    w = st.eval(tu)
                    for col in cols:
                        pacc += w[col[bi], inv]
                else:
                    # large batch: the R×n table outgrows the per-variant
                    # overhead — evaluate each (view, GN) on its own subset
                    for group in variants:
                        if len(group) == 1:
                            vt, arr, _ = group[0]
                            pacc += _eval_staircase(vt, t, arr)
                            continue
                        for vt, arr, rowmask in group:
                            sel = rowmask[bi]
                            if sel.any():
                                pacc[sel] += _eval_staircase(vt, t[sel], arr)
                acc = acc + pacc
            nx = base[bi, ji] + (acc + const)
            over = nx > limit
            conv = ~over & (nx <= t + _EPS)
            res[bi[conv], ji[conv]] = nx[conv]
            cont = ~(over | conv)
            x[bi[cont], ji[cont]] = nx[cont]
            done = over | conv
            active[bi[done], ji[done]] = False
        metrics.inc("rta_batch_iters_total", amount=it + 1)
        return res

    @staticmethod
    def _scalar_tail(
        base_v: float,
        x_v: float,
        limit: float,
        parts,
        const: float,
        row: int,
        iters_left: int,
        horizon: float,
    ) -> float:
        """Finish one entry's fixed point scalar-style from iterate ``x_v``.

        Continues the exact lockstep trajectory (same update expression,
        same association and float operations), so the result is
        bit-identical to having kept iterating in vector form — or to
        ``rta.fixed_point`` itself.  The iterate sequence is monotone
        non-decreasing, so each view keeps a per-row position pointer that
        only ever walks forward: one iteration costs O(rows) comparisons,
        not O(rows·log positions) cached bisects.
        """
        walkers = []
        for groups in parts:
            ws = []
            for grp in groups:
                vt = grp.vt_by_gn[int(grp.gn_col[row])]
                cls, cl, ln, minh = vt.as_lists(horizon)
                if minh <= limit:
                    # degenerate view (position cap) — generic slow path
                    ws.append((None, None, None, vt))
                else:
                    ws.append((cls, cl, ln, [0] * len(cls)))
            walkers.append(ws)
        x = x_v
        for _ in range(iters_left):
            acc = 0.0
            for ws in walkers:
                pacc = 0.0
                for cls, cl, ln, aux in ws:
                    if cls is None:
                        pacc += aux.max_workload(x)
                        continue
                    if x <= 0.0:
                        continue
                    best = 0.0
                    for r in range(len(cls)):
                        crow = cls[r]
                        p = aux[r]
                        while crow[p] <= x:
                            p += 1
                        aux[r] = p
                        if p:
                            consumed = crow[p - 1]
                            work = cl[r][p - 1]
                        else:
                            consumed = 0.0
                            work = 0.0
                        partial = ln[r][p]
                        gap = x - consumed
                        if partial > gap:
                            partial = gap
                        if partial > 0.0:
                            work += partial
                        if work > best:
                            best = work
                    pacc += best
                acc = acc + pacc
            nx = base_v + (acc + const)
            if nx > limit:
                return _INF
            if nx <= x + _EPS:
                return nx
            x = nx
        return _INF

    def fixed_point_rows(
        self,
        base: np.ndarray,           # (R,)
        limit: np.ndarray,          # (R,) per-row limit (deadline)
        const: np.ndarray,          # (R,) per-row additive constant
        idx1: np.ndarray,           # (R, P1) part-1 pair indices, G = sentinel
        idx2: Optional[np.ndarray],  # (R, P2) part-2 pair indices, or None
        stack: Optional[_PartStack],
        horizon: float = 0.0,
    ) -> np.ndarray:
        """Heterogeneous fixed points in lockstep: every row carries its own
        base/limit/const and its own higher-priority pair set.

        Rows index into ONE shared :class:`_PartStack`; the sentinel index
        ``G`` (== number of pairs) selects an all-zeros workload row, so
        ragged pair lists right-pad with ``G`` — adding ``0.0`` to a
        non-negative partial sum is a bitwise no-op, preserving the scalar
        association ``(0 + w_1 + ... + w_k)``.  Rows with ``idx2`` add a
        second partial sum (the tightened R̂3 two-part interference):
        ``acc = (0 + pacc1) + pacc2`` exactly as the scalar closure.
        """
        R = base.shape[0]
        if R == 0:
            return np.zeros(0)
        metrics.inc("rta_rows_calls_total")
        G = 0 if stack is None else len(stack.pair_starts)
        res = np.full(R, _INF)
        active = base <= limit
        x = base.copy()
        it = -1
        for it in range(_MAX_ITERS):
            ai = np.nonzero(active)[0]
            if ai.size == 0:
                break
            if ai.size <= self._TAIL_ROWS:
                metrics.inc("rta_batch_stragglers_total", amount=ai.size)
                for r in ai.tolist():
                    p1 = [stack.refs[p][0] for p in idx1[r] if p < G]
                    p2 = None
                    if idx2 is not None:
                        p2 = [stack.refs[p][0] for p in idx2[r] if p < G]
                    res[r] = self._scalar_tail_rows(
                        base[r], x[r], limit[r], const[r], p1, p2,
                        _MAX_ITERS - it, horizon,
                    )
                break
            t = x[ai]
            if stack is None:
                w = inv = None
            else:
                tu, inv = np.unique(t, return_inverse=True)
                # sentinel row G: zero workload for padded pair slots
                w = np.vstack([stack.eval(tu), np.zeros((1, tu.size))])
            pacc = np.zeros_like(t)
            if w is not None:
                # one fancy gather for the whole pair matrix, then a
                # column-by-column left fold — the scalar association
                # (0 + w_1 + ... + w_k) at a fraction of the dispatches
                m1 = w[idx1[ai], inv[:, None]]
                for j in range(m1.shape[1]):
                    pacc = pacc + m1[:, j]
            acc = np.zeros_like(t) + pacc
            if idx2 is not None and w is not None:
                pacc2 = np.zeros_like(t)
                m2 = w[idx2[ai], inv[:, None]]
                for j in range(m2.shape[1]):
                    pacc2 = pacc2 + m2[:, j]
                acc = acc + pacc2
            nx = base[ai] + (acc + const[ai])
            lim = limit[ai]
            over = nx > lim
            conv = ~over & (nx <= t + _EPS)
            res[ai[conv]] = nx[conv]
            cont = ~(over | conv)
            x[ai[cont]] = nx[cont]
            active[ai[over | conv]] = False
        metrics.inc("rta_batch_iters_total", amount=it + 1)
        return res

    @staticmethod
    def _scalar_tail_rows(
        base_v: float,
        x_v: float,
        limit_v: float,
        const_v: float,
        vts1: list,
        vts2: Optional[list],
        iters_left: int,
        horizon: float,
    ) -> float:
        """Scalar continuation for one fused row (see ``_scalar_tail``).

        Same monotone-pointer walk and the same float associations as the
        vector path: ``acc = (0 + pacc1) [+ pacc2]``, ``nx = base +
        (acc + const)`` — bit-identical to having kept iterating in
        lockstep, and to ``rta.fixed_point``.
        """
        def mk(vts):
            ws = []
            for vt in vts:
                cls, cl, ln, minh = vt.as_lists(horizon)
                if minh <= limit_v:
                    # degenerate view (position cap) — generic slow path
                    ws.append((None, None, None, vt))
                else:
                    ws.append((cls, cl, ln, [0] * len(cls)))
            return ws

        walkers = [mk(vts1)]
        if vts2 is not None:
            walkers.append(mk(vts2))
        x = x_v
        for _ in range(iters_left):
            acc = 0.0
            for ws in walkers:
                pacc = 0.0
                for cls, cl, ln, aux in ws:
                    if cls is None:
                        pacc += aux.max_workload(x)
                        continue
                    if x <= 0.0:
                        continue
                    best = 0.0
                    for r in range(len(cls)):
                        crow = cls[r]
                        p = aux[r]
                        while crow[p] <= x:
                            p += 1
                        aux[r] = p
                        if p:
                            consumed = crow[p - 1]
                            work = cl[r][p - 1]
                        else:
                            consumed = 0.0
                            work = 0.0
                        partial = ln[r][p]
                        gap = x - consumed
                        if partial > gap:
                            partial = gap
                        if partial > 0.0:
                            work += partial
                        if work > best:
                            best = work
                    pacc += best
                acc = acc + pacc
            nx = base_v + (acc + const_v)
            if nx > limit_v:
                return _INF
            if nx <= x + _EPS:
                return nx
            x = nx
        return _INF


_ENGINES: dict[str, object] = {}


def _engine(name: Optional[str] = None):
    name = name or get_backend()
    if name not in ("numpy",):
        raise ValueError(f"unknown RTA backend {name!r}")
    if name not in _ENGINES:
        _ENGINES[name] = _NumpyEngine()
    return _ENGINES[name]


# ---- batched per-depth analysis ---------------------------------------------


def _seq_sum(mat: np.ndarray) -> np.ndarray:
    """Row sums accumulated column-by-column (matches Python ``sum``)."""
    acc = np.zeros(mat.shape[0])
    for j in range(mat.shape[1]):
        acc = acc + mat[:, j]
    return acc


@dataclasses.dataclass
class DepthAnalysis:
    """Batched analysis of task ``k`` for a frontier of candidates.

    Children (one per candidate) index their shared interference context
    through ``parent``: ``mem_resp``/``cpu_resp`` are *per parent prefix*
    (they do not depend on the candidate's own GN), ``r1``/``r2`` per
    child."""

    k: int
    name: str
    deadline: float
    g: np.ndarray          # (Bc,) candidate's own GN
    parent: np.ndarray     # (Bc,) -> row of mem_resp / cpu_resp
    mem_resp: np.ndarray   # (Bp, n_mem)
    cpu_resp: np.ndarray   # (Bp, m)
    r1: np.ndarray         # (Bc,)
    r2: np.ndarray         # (Bc,)
    gpu_bounds: dict[int, tuple[tuple[float, ...], tuple[float, ...]]]
    #: per-child preemptive kernel responses (priority arbitration only) —
    #: replaces the dedicated Lemma-5.1 upper bounds in gpu_bounds
    gpu_resp: Optional[np.ndarray] = None   # (Bc, n_gpu)

    @property
    def response(self) -> np.ndarray:
        return np.minimum(self.r1, self.r2)

    @property
    def schedulable(self) -> np.ndarray:
        return self.response <= self.deadline + 1e-6

    def task_analysis(self, i: int) -> TaskAnalysis:
        """Materialize the scalar-path :class:`TaskAnalysis` for child i."""
        p = int(self.parent[i])
        g = int(self.g[i])
        lo, hi = self.gpu_bounds[g]
        if self.gpu_resp is not None:
            hi = tuple(float(v) for v in self.gpu_resp[i])
        return TaskAnalysis(
            name=self.name,
            n_vsm=2 * g,
            gpu_resp_lo=lo,
            gpu_resp_hi=hi,
            mem_resp_hi=tuple(float(v) for v in self.mem_resp[p]),
            cpu_resp_hi=tuple(float(v) for v in self.cpu_resp[p]),
            r1=float(self.r1[i]),
            r2=float(self.r2[i]),
            deadline=self.deadline,
        )


class BatchAnalyzer:
    """Vectorized counterpart of :class:`repro_torch.core.rta.RtgpuIncremental`.

    Shares the same ``AnalysisTables`` view cache (and therefore the same
    compiled staircases) as the scalar path, so warm controllers hand their
    tables straight in.  ``backend`` overrides ``repro_torch.core.backend``'s
    process-wide selection for this analyzer only.
    """

    def __init__(
        self,
        taskset: TaskSet,
        tightened: bool = False,
        tables: Optional[AnalysisTables] = None,
        backend: Optional[str] = None,
        preemption: "PreemptionModel | str | None" = None,
    ):
        self.taskset = taskset
        self.tightened = tightened
        self.preemption = PreemptionModel.coerce(preemption)
        self._inc = RtgpuIncremental(taskset, tightened=tightened,
                                     tables=tables,
                                     preemption=self.preemption)
        self._engine = _engine(backend)
        self._gpu_cache: dict[tuple[int, int], tuple] = {}
        # Largest window any fixed point in this task set can query: its
        # own limit is its deadline, so staircase arrays compiled to the
        # max deadline answer every lookup without the scalar fallback.
        self._horizon = max(t.deadline for t in taskset)

    @property
    def scalar(self) -> RtgpuIncremental:
        """The underlying scalar analyzer (reference oracle, shared views)."""
        return self._inc

    def _gpu(self, k: int, g: int) -> tuple:
        """(gpu_resp_lo, gpu_resp_hi, Σ gpu_resp_hi) for task k at GN g."""
        key = (k, g)
        got = self._gpu_cache.get(key)
        if got is None:
            bounds = [seg.response_bounds(2 * g) for seg in self.taskset[k].gpu]
            lo = tuple(b[0] for b in bounds)
            hi = tuple(b[1] for b in bounds)
            got = (lo, hi, sum(hi))
            self._gpu_cache[key] = got
        return got

    def _groups(
        self, k: int, kind: str, parent_prefixes: np.ndarray
    ) -> list[_HpGroup]:
        ts = self.taskset
        fetch = {
            "mem": self._inc.mem_tables,
            "cpu": self._inc.cpu_tables,
            "gpu": self._inc.gpu_tables,
        }[kind]
        groups: list[_HpGroup] = []
        for i in range(k):
            if kind == "mem" and not ts[i].n_mem:
                continue
            if kind == "gpu" and not ts[i].n_gpu:
                continue
            col = parent_prefixes[:, i]
            vt_by_gn = {int(g): fetch(i, int(g)) for g in np.unique(col)}
            groups.append(_HpGroup(vt_by_gn=vt_by_gn, gn_col=col))
        return groups

    def analyze_depth(
        self,
        k: int,
        parent_prefixes: np.ndarray,  # (Bp, k) GN for tasks 0..k-1
        g: np.ndarray,                # (Bc,) candidate GN for task k
        parent: np.ndarray,           # (Bc,) -> parent prefix row
    ) -> DepthAnalysis:
        """Analyze task k for every candidate ``(parent prefix, own GN)``."""
        task = self.taskset[k]
        limit = task.deadline
        blocking = self._inc._blocking[k]
        bp = parent_prefixes.shape[0]
        bc = g.shape[0]

        mem_groups = self._groups(k, "mem", parent_prefixes)
        cpu_groups = self._groups(k, "cpu", parent_prefixes)

        # Lemma 5.3 / 5.5 fixed points: per *parent* (own GN not involved)
        mem_resp = self._engine.fixed_point_batch(
            np.tile(np.asarray(task.mem_hi, dtype=np.float64), (bp, 1)),
            limit, [mem_groups], blocking, self._horizon,
        )
        cpu_resp = self._engine.fixed_point_batch(
            np.tile(np.asarray(task.cpu_hi, dtype=np.float64), (bp, 1)),
            limit, [cpu_groups], 0.0, self._horizon,
        )
        mem_sum = _seq_sum(mem_resp)
        cpu_sum = _seq_sum(cpu_resp)
        mem_bad = np.isinf(mem_resp).any(axis=1)
        cpu_bad = np.isinf(cpu_resp).any(axis=1)

        # Theorem 5.6 combination: per *child* (own GN enters via Lemma 5.1)
        uniq_g, inv = np.unique(g, return_inverse=True)
        gpu_resp = None
        if self.preemption.enabled and task.n_gpu:
            # Preemptive GPU (GCAPS-style): per-child fixed points over
            # higher-priority GPU occupancy — base = each kernel's
            # dedicated-speed bound at the child's own GN, interference at
            # the parent's prefix, const = the lower-priority blocking term.
            # Lockstep twin of the scalar interf_g closure (bit-identical).
            gpu_groups = self._groups(k, "gpu", parent_prefixes)
            child_gpu = [
                _HpGroup(grp.vt_by_gn, grp.gn_col[parent])
                for grp in gpu_groups
            ]
            gbase = np.array(
                [self._gpu(k, int(gv))[1] for gv in uniq_g], dtype=np.float64
            )[inv]
            gpu_resp = self._engine.fixed_point_batch(
                gbase, limit, [child_gpu], self._inc._gpu_blocking[k],
                self._horizon,
            )
            gpu_sum = _seq_sum(gpu_resp)
        else:
            gpu_sum = np.array([self._gpu(k, int(gv))[2] for gv in uniq_g])[inv]

        r1 = (gpu_sum + mem_sum[parent]) + cpu_sum[parent]
        r1[(mem_bad | cpu_bad)[parent]] = _INF

        ctot = task.cpu_total_hi()
        base2 = (gpu_sum + mem_sum[parent]) + ctot
        base2[mem_bad[parent]] = _INF
        child_cpu = [
            _HpGroup(grp.vt_by_gn, grp.gn_col[parent]) for grp in cpu_groups
        ]
        r2 = self._engine.fixed_point_batch(
            base2[:, None], limit, [child_cpu], 0.0, self._horizon
        )[:, 0]

        if self.tightened:
            base3 = ((gpu_sum + task.mem_total_hi()) + ctot) \
                + task.n_mem * blocking
            child_mem = [
                _HpGroup(grp.vt_by_gn, grp.gn_col[parent])
                for grp in mem_groups
            ]
            r3 = self._engine.fixed_point_batch(
                base3[:, None], limit, [child_mem, child_cpu], 0.0,
                self._horizon,
            )[:, 0]
            r2 = np.minimum(r2, r3)

        return DepthAnalysis(
            k=k,
            name=task.name or f"task{k}",
            deadline=limit,
            g=np.asarray(g),
            parent=np.asarray(parent),
            mem_resp=mem_resp,
            cpu_resp=cpu_resp,
            r1=r1,
            r2=r2,
            gpu_bounds={
                int(gv): self._gpu(k, int(gv))[:2] for gv in uniq_g
            },
            gpu_resp=gpu_resp,
        )

    def analyze_prefixes(
        self, k: int, prefixes: np.ndarray, dedupe: bool = True
    ) -> DepthAnalysis:
        """Analyze task k for explicit ``(B, k+1)`` allocation prefixes.

        With ``dedupe`` the shared higher-priority contexts are collapsed,
        so e.g. a pinned 1-D admission sweep (candidates differing only in
        the arrival's GN) pays for each distinct interference prefix once.
        """
        prefixes = np.asarray(prefixes, dtype=np.int64)
        if prefixes.ndim != 2 or prefixes.shape[1] != k + 1:
            raise ValueError(f"need a (B, {k + 1}) prefix matrix")
        metrics.observe("rta_frontier_width", prefixes.shape[0],
                        buckets=metrics.DEFAULT_RESPONSE_BUCKETS)
        parents_full = prefixes[:, :k]
        g = prefixes[:, k]
        if dedupe and parents_full.shape[0] > 1:
            uniq, inv = np.unique(parents_full, axis=0, return_inverse=True)
            return self.analyze_depth(k, uniq, g, inv.ravel())
        return self.analyze_depth(
            k, parents_full, g, np.arange(prefixes.shape[0])
        )

    def analyze_pinned(
        self,
        a: int,
        alloc_interf: Sequence[int],
        alloc_self: Sequence[int],
        gs: Sequence[int],
        k_lo: Optional[int] = None,
        k_hi: Optional[int] = None,
    ) -> np.ndarray:
        """R̂ for tasks ``k_lo..k_hi`` at every candidate GN of position a.

        The pinned-sweep / coordinate-descent shape: candidates share every
        allocation except position ``a``'s, which takes each value of
        ``gs`` — as the task's own GN *and* as its interference on lower
        priority.  Positions ``i != a`` contribute interference at
        ``alloc_interf[i]`` and run at ``alloc_self[i]`` (the two differ
        for residents mid-transition).  Tasks above ``a`` are untouched by
        construction — callers reuse their memoized bounds instead.

        ``k_lo``/``k_hi`` (inclusive, defaulting to ``a`` / ``n - 1``)
        bound the analyzed tasks, so callers can probe just the pinned
        task (a failing candidate is killed at one row's cost, matching
        the scalar path's probe-first trick) or stop at the first task a
        descent move could possibly fix.  Per-task results are unaffected
        — each task's analysis is independent given the allocation.

        Returns a ``(len(gs), k_hi - k_lo + 1)`` response matrix (``inf``
        = unschedulable), bit-identical per entry to
        ``RtgpuIncremental.analyze_task``: ALL per-segment fixed points
        (bus, CPU, preemptive GPU) across every (task, candidate) go
        through ONE fused-rows engine call, and all R̂2/R̂3 combinations
        through a second — two array dispatches replace the
        O(candidates × tasks) scalar analyses of the fallback path.
        """
        ts = self.taskset
        n = len(ts)
        gs_l = [int(g) for g in gs]
        C = len(gs_l)
        k_lo = a if k_lo is None else k_lo
        k_hi = n - 1 if k_hi is None else k_hi
        if not a <= k_lo <= n:
            raise ValueError(f"k_lo {k_lo} outside [{a}, {n}]")
        if C == 0 or a >= n or k_hi < k_lo:
            return np.zeros((C, max(k_hi - k_lo + 1, 0)))
        pre = self.preemption.enabled
        horizon = self._horizon
        inc = self._inc
        pidx: dict[tuple, int] = {}
        plist: list[tuple] = []
        fetch = {"mem": inc.mem_tables, "cpu": inc.cpu_tables,
                 "gpu": inc.gpu_tables}

        def pair(kind: str, i: int, g: int) -> int:
            key = (kind, i, g)
            s = pidx.get(key)
            if s is None:
                vt = fetch[kind](i, g)
                s = len(plist)
                pidx[key] = s
                plist.append((vt, vt.as_arrays(horizon)))
            return s

        apairs: dict[str, list[int]] = {}

        def a_pairs(kind: str) -> list[int]:
            got = apairs.get(kind)
            if got is None:
                got = [pair(kind, a, g) for g in gs_l]
                apairs[kind] = got
            return got

        def kind_lists(kind: str, k: int) -> tuple[list[list[int]], bool]:
            """Per-candidate higher-priority pair lists for ``(kind, k)``,
            in priority order; shared when position a carries no view of
            this kind below k."""
            tmpl: list[int] = []
            aslot = None
            for i in range(k):
                if kind == "mem" and not ts[i].n_mem:
                    continue
                if kind == "gpu" and not ts[i].n_gpu:
                    continue
                if i == a:
                    aslot = len(tmpl)
                    tmpl.append(-1)
                else:
                    tmpl.append(pair(kind, i, int(alloc_interf[i])))
            if aslot is None:
                return [tmpl] * C, True
            ap = a_pairs(kind)
            out = []
            for c in range(C):
                pl = list(tmpl)
                pl[aslot] = ap[c]
                out.append(pl)
            return out, False

        # ---- phase 1: every per-segment fixed point as one rows call ----
        base1: list[float] = []
        lim1: list[float] = []
        con1: list[float] = []
        pl1: list[list[int]] = []

        def emit1(b: float, d: float, co: float, pl: list[int]) -> int:
            base1.append(b)
            lim1.append(d)
            con1.append(co)
            pl1.append(pl)
            return len(base1) - 1

        blocking = inc._blocking
        g_blocking = inc._gpu_blocking
        recs = []
        for k in range(k_lo, k_hi + 1):
            task = ts[k]
            d = task.deadline
            mem_pls, mem_shared = kind_lists("mem", k)
            cpu_pls, cpu_shared = kind_lists("cpu", k)
            m = len(task.cpu_hi)
            rec: dict = {"task": task, "d": d, "k": k, "m": m,
                         "mem_pls": mem_pls, "cpu_pls": cpu_pls}
            if task.n_mem:
                span = [0] if mem_shared else range(C)
                rec["mem_rows"] = [
                    [emit1(task.mem_hi[j], d, blocking[k], mem_pls[c])
                     for j in range(task.n_mem)]
                    for c in span
                ]
            if m:
                span = [0] if cpu_shared else range(C)
                rec["cpu_rows"] = [
                    [emit1(task.cpu_hi[j], d, 0.0, cpu_pls[c])
                     for j in range(m)]
                    for c in span
                ]
            if pre and task.n_gpu:
                gpu_pls, gpu_shared = kind_lists("gpu", k)
                if gpu_shared and k != a:
                    # hp set and own GN both candidate-independent
                    hi = self._gpu(k, int(alloc_self[k]))[1]
                    rec["gpu_rows"] = [
                        [emit1(hi[j], d, g_blocking[k], gpu_pls[0])
                         for j in range(task.n_gpu)]
                    ]
                else:
                    rows = []
                    for c in range(C):
                        own = gs_l[c] if k == a else int(alloc_self[k])
                        hi = self._gpu(k, own)[1]
                        rows.append(
                            [emit1(hi[j], d, g_blocking[k], gpu_pls[c])
                             for j in range(task.n_gpu)]
                        )
                    rec["gpu_rows"] = rows
            recs.append(rec)

        # every pair of BOTH phases is registered by now (phase 2 reuses
        # the mem/cpu lists above), so one stack serves both calls
        stack = self._engine.rows_stack(plist)
        G = len(plist)

        def to_idx(pls: list[list[int]]) -> np.ndarray:
            width = max((len(p) for p in pls), default=0)
            out = np.full((len(pls), max(width, 1)), G, dtype=np.int64)
            for r, pl in enumerate(pls):
                if pl:
                    out[r, :len(pl)] = pl
            return out

        resp1 = self._engine.fixed_point_rows(
            np.asarray(base1, dtype=np.float64),
            np.asarray(lim1, dtype=np.float64),
            np.asarray(con1, dtype=np.float64),
            to_idx(pl1), None, stack, horizon,
        )

        def gathered(rows: Optional[list], cnt: int) -> np.ndarray:
            if not cnt or rows is None:
                return np.zeros((C, 0))
            got = resp1[np.asarray(rows, dtype=np.int64)]
            if got.shape[0] == 1 and C > 1:
                got = np.broadcast_to(got, (C, cnt))
            return got

        # ---- phase 2: all R̂2 / tightened-R̂3 combinations ----
        r1s: list[np.ndarray] = []
        base2l: list[float] = []
        lim2l: list[float] = []
        pl2a: list[list[int]] = []
        pl2b: list[list[int]] = []
        r2_ids: list[list[int]] = []
        r3_ids: list[list[int]] = []
        for rec in recs:
            task = rec["task"]
            k = rec["k"]
            d = rec["d"]
            mem = gathered(rec.get("mem_rows"), task.n_mem)
            cpu = gathered(rec.get("cpu_rows"), rec["m"])
            mem_sum = _seq_sum(mem)
            cpu_sum = _seq_sum(cpu)
            if pre and task.n_gpu:
                gpu_sum = _seq_sum(gathered(rec["gpu_rows"], task.n_gpu))
            elif task.n_gpu:
                if k == a:
                    gpu_sum = np.array(
                        [self._gpu(k, g)[2] for g in gs_l], dtype=np.float64
                    )
                else:
                    gpu_sum = np.full(
                        C, self._gpu(k, int(alloc_self[k]))[2]
                    )
            else:
                gpu_sum = np.zeros(C)
            mem_bad = (np.isinf(mem).any(axis=1) if task.n_mem
                       else np.zeros(C, dtype=bool))
            cpu_bad = (np.isinf(cpu).any(axis=1) if rec["m"]
                       else np.zeros(C, dtype=bool))
            r1 = (gpu_sum + mem_sum) + cpu_sum
            r1[mem_bad | cpu_bad] = _INF
            r1s.append(r1)

            ctot = task.cpu_total_hi()
            base2 = (gpu_sum + mem_sum) + ctot
            base2[mem_bad] = _INF
            ids2 = []
            for c in range(C):
                base2l.append(float(base2[c]))
                lim2l.append(d)
                pl2a.append(rec["cpu_pls"][c])
                pl2b.append([])
                ids2.append(len(base2l) - 1)
            r2_ids.append(ids2)
            if self.tightened:
                base3 = ((gpu_sum + task.mem_total_hi()) + ctot) \
                    + task.n_mem * blocking[k]
                ids3 = []
                for c in range(C):
                    base2l.append(float(base3[c]))
                    lim2l.append(d)
                    pl2a.append(rec["mem_pls"][c])
                    pl2b.append(rec["cpu_pls"][c])
                    ids3.append(len(base2l) - 1)
                r3_ids.append(ids3)

        resp2 = self._engine.fixed_point_rows(
            np.asarray(base2l, dtype=np.float64),
            np.asarray(lim2l, dtype=np.float64),
            np.zeros(len(base2l)),
            to_idx(pl2a),
            to_idx(pl2b) if self.tightened else None,
            stack, horizon,
        )

        out = np.empty((C, k_hi - k_lo + 1))
        for t_i in range(len(recs)):
            r2 = resp2[np.asarray(r2_ids[t_i], dtype=np.int64)]
            if self.tightened:
                r3 = resp2[np.asarray(r3_ids[t_i], dtype=np.int64)]
                r2 = np.minimum(r2, r3)
            out[:, t_i] = np.minimum(r1s[t_i], r2)
        return out


# ---- frontier grid search ---------------------------------------------------


def grid_search_frontier(
    taskset: TaskSet,
    gn_total: int,
    tightened: bool = False,
    max_nodes: int = 1_000_000,
    hint: Optional[Sequence[Optional[int]]] = None,
    tables: Optional[AnalysisTables] = None,
    backend: Optional[str] = None,
    preemption: "PreemptionModel | str | None" = None,
):
    """Algorithm 2 as a breadth-wise batched frontier search.

    Result-identical to :func:`repro_torch.core.federated.grid_search_dfs`: the
    frontier is kept in the DFS's visit order (lexicographic, hint-first
    when warm-started), so the first schedulable full-depth candidate is
    the same allocation, with the same per-task analysis.  Differences:
    ``candidates_tried`` counts breadth-wise work (all surviving prefixes
    of a depth are analyzed before descending; the DFS stops expanding at
    its first success), and when ``max_nodes`` truncates the search the
    two engines may give up on different subtrees.

    The final depth is analyzed in lexicographic chunks with early exit,
    so a search that succeeds does not pay for the whole last level.
    """
    from .federated import FederatedResult, _suffix_mins, min_viable_alloc

    n = len(taskset)
    mins = min_viable_alloc(taskset, gn_total)
    if mins is None:
        return FederatedResult(False, None, None, 0)
    suffix = _suffix_mins(mins)

    ana = BatchAnalyzer(taskset, tightened=tightened, tables=tables,
                        backend=backend, preemption=preemption)
    tried = 0
    prefixes = np.zeros((1, 0), dtype=np.int64)
    rems = np.array([gn_total], dtype=np.int64)
    # per depth: (DepthAnalysis, kept child rows) for winner reconstruction
    store: list[tuple[DepthAnalysis, np.ndarray]] = []

    def reconstruct(da: DepthAnalysis, w: int) -> "FederatedResult":
        chain: list[TaskAnalysis] = [da.task_analysis(w)]
        alloc = [int(da.g[w])]
        pos = int(da.parent[w])
        for depth in range(n - 2, -1, -1):
            prev, keep = store[depth]
            row = int(keep[pos])
            chain.append(prev.task_analysis(row))
            alloc.append(int(prev.g[row]))
            pos = int(prev.parent[row])
        chain.reverse()
        alloc.reverse()
        return FederatedResult(
            True, tuple(alloc), SetAnalysis(tuple(chain)), tried
        )

    for k in range(n):
        lo = mins[k]
        his = rems - suffix[k + 1]
        h = hint[k] if hint is not None and k < len(hint) else None
        if h is None:
            counts = np.maximum(his - lo + 1, 0)
            parent = np.repeat(np.arange(len(rems)), counts)
            starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
            g = (np.arange(int(counts.sum())) - starts[parent]) + lo
        else:
            pl: list[int] = []
            gl: list[int] = []
            for p, hi in enumerate(his.tolist()):
                if lo <= h <= hi:
                    order = [h] + [x for x in range(lo, hi + 1) if x != h]
                else:
                    order = list(range(lo, hi + 1))
                gl.extend(order)
                pl.extend([p] * len(order))
            parent = np.asarray(pl, dtype=np.int64)
            g = np.asarray(gl, dtype=np.int64)

        if k < n - 1:
            budget = max_nodes - tried
            if len(g) > budget:
                g, parent = g[:budget], parent[:budget]
            if len(g) == 0:
                return FederatedResult(False, None, None, tried)
            da = ana.analyze_depth(k, prefixes, g, parent)
            tried += len(g)
            keep = np.nonzero(da.schedulable)[0]
            store.append((da, keep))
            if keep.size == 0:
                return FederatedResult(False, None, None, tried)
            prefixes = np.concatenate(
                [prefixes[parent[keep]], g[keep, None]], axis=1
            )
            rems = rems[parent[keep]] - g[keep]
        else:
            offset = 0
            while offset < len(g):
                take = min(_FINAL_CHUNK, len(g) - offset, max_nodes - tried)
                if take <= 0:
                    break
                cg = g[offset:offset + take]
                cp = parent[offset:offset + take]
                da = ana.analyze_depth(k, prefixes, cg, cp)
                tried += take
                sched = np.nonzero(da.schedulable)[0]
                if sched.size:
                    return reconstruct(da, int(sched[0]))
                offset += take
            return FederatedResult(False, None, None, tried)

    raise AssertionError("unreachable")  # pragma: no cover
