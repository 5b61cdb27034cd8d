"""Certification engines: RTGPU analysis of transitional ledger states.

The middle layer of the scheduling stack.  Given a set of
:class:`~repro_torch.sched.capacity.Entry` ledger entries (committed + staged
state), a certification engine answers one question — *does every task
meet its deadline in every mode the transition can pass through?* — and
produces the certified R̂ bound per task.  Three analysis paths hide
behind one interface:

  * the **scalar pinned loop**: per-task ``RtgpuIncremental`` analyses,
    memoized on each task's complete interference context (shared by both
    engines for rate changes and for small admission sweeps, where NumPy
    dispatch constants dominate);
  * the **batched sweep** (:class:`BatchCertifier`): every candidate GN of
    an arrival certified in one vectorized
    :class:`~repro_torch.core.rta_batch.BatchAnalyzer` pass per (task, vector);
  * the **re-allocation search**: Algorithm 2 warm-started with the
    incumbent allocation (scalar DFS or breadth-wise frontier).

**Transitional envelope.**  When any entry is mid-transition the set is
certified at three allocation vectors — all-committed, all-target, and
the mixed envelope (higher-priority interference at ``gn_hi``, own GPU
segments at ``gn_lo``) — with each entry analyzed at its parameter
envelope (``Entry.trans_task``: min T, min D).  Each task's certified
bound is the max over the variants, so jobs of either epoch and jobs
spanning the switch are all covered.  :func:`transitional_vectors` is the
single source of truth for BOTH engines; scalar and batched certification
are decision- and bound-identical (``tests/test_rta_batch.py``).

The engines are *pure* with respect to controller state: they read and
warm the caller-provided fork of the analysis tables / memo, and never
touch the ledger — committing a certified state is the protocol layer's
(:mod:`repro_torch.sched.controller`) job.
"""
from __future__ import annotations

import abc
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import AnalysisTables, PreemptionModel, RTTask, TaskSet
from repro_torch.core.federated import FederatedResult, grid_search_dfs
from repro_torch.core.rta import RtgpuIncremental, SetAnalysis, bus_blocking
from repro_torch.core.rta_batch import BatchAnalyzer, grid_search_frontier
from repro_torch.obs import metrics

from .capacity import Entry

__all__ = [
    "CertificationEngine",
    "MemoOverlay",
    "ScalarCertifier",
    "BatchCertifier",
    "PreemptiveCertifier",
    "make_certifier",
    "transitional_vectors",
]

_EPS = 1e-9


def _memo_key(
    ordered: Sequence[Entry],
    interf_vec: Sequence[int],
    self_vec: Sequence[int],
    k: int,
    blocking: Sequence[float],
    g_blocking: Optional[Sequence[float]],
) -> tuple:
    """The certify-memo key: task k's complete interference context.

    Higher-priority (task, GN) prefix, own (task, GN), bus blocking from
    below — plus, under preemptive arbitration, the GPU blocking term.
    The single source of truth for every certification path (the scalar
    loop and both batched sweeps), so memo entries written by one path are
    reused verbatim by the others."""
    key = (
        tuple((ordered[i].trans_task, interf_vec[i]) for i in range(k)),
        (ordered[k].trans_task, self_vec[k]),
        blocking[k],
    )
    if g_blocking is not None:
        key = key + (g_blocking[k],)
    return key


class MemoOverlay:
    """Copy-on-write view over the controller's certify memo.

    Every transactional operation used to snapshot the memo with
    ``dict(self._memo)`` so a rejected decision could drop its writes —
    an O(memo) copy (up to ``_MEMO_LIMIT`` = 20k entries) on EVERY admit,
    which is exactly the O(total-resident-history) term that kept fleet
    admission from being O(affected neighborhood).  The overlay replaces
    the copy: reads fall through to the shared base dict, writes land in
    a private local dict, and only a *successful* decision flushes the
    local writes into the base (:meth:`flush_into`).  A rejection drops
    the overlay — the base was never touched — preserving the
    fork-and-adopt transactionality byte for byte.

    Only the two operations the certification paths use are implemented
    (``get`` and item assignment); memo values are response-time floats
    and never ``None``, so the sentinel fall-through in :meth:`get` is
    exact."""

    __slots__ = ("base", "local")

    def __init__(self, base: dict):
        self.base = base
        self.local: dict = {}

    def get(self, key, default=None):
        v = self.local.get(key)
        if v is not None:
            return v
        return self.base.get(key, default)

    def __setitem__(self, key, value) -> None:
        self.local[key] = value

    def flush_into(self, base: dict) -> None:
        """Commit the transaction's writes into the shared base memo."""
        base.update(self.local)


def transitional_vectors(
    ordered: Sequence[Entry],
) -> list[tuple[list[int], list[int]]]:
    """Allocation vectors a transitional set is certified at — the single
    source of truth for BOTH engines: the mixed envelope (hp interference
    at gn_hi, own GPU at gn_lo) plus, when any entry is mid-transition,
    the two pure vectors (all-committed, all-target)."""
    vectors: list[tuple[list[int], list[int]]] = [
        ([e.gn_hi for e in ordered], [e.gn_lo for e in ordered]),
    ]
    if any(e.in_transition for e in ordered):
        vectors.append(([e.alloc for e in ordered],) * 2)
        vectors.append(([e.target_alloc for e in ordered],) * 2)
    return vectors


class CertificationEngine(abc.ABC):
    """One certification strategy over ledger entries.

    All engines share the memoized scalar :meth:`certify` (the reference
    path for full-set certification); they differ in how the *pinned
    admission sweep* and the *re-allocation fallback* are evaluated.
    """

    name = "abstract"
    #: whether :meth:`realloc_search` understands time-shared (overlapping)
    #: slice sets — the controller only opens the re-allocation fallback
    #: under preemptive arbitration for engines that set this
    supports_preemptive_realloc = False

    def __init__(
        self,
        tightened: bool = True,
        preemption: "PreemptionModel | str | None" = None,
    ):
        self.tightened = tightened
        # GPU arbitration model certified against: "none" keeps the paper's
        # dedicated federated slices, "priority" adds the GCAPS-style
        # preemptive interference/blocking terms (repro_torch.core.rta).
        self.preemption = PreemptionModel.coerce(preemption)

    def certify(
        self,
        entries: Sequence[Entry],
        tables: AnalysisTables,
        memo: dict[tuple, float],
        probe: Optional[str] = None,
        partial: bool = False,
    ) -> tuple[Optional[dict[str, float]], int, str]:
        """Full RTGPU analysis of the transitional set.

        Returns ``(bounds, analyses, reason)``; ``bounds`` is None when
        some task fails.  With ``partial=True`` failure does not
        short-circuit: every task gets a bound (``inf`` marks the
        unschedulable ones) — the per-task view crash recovery needs to
        quarantine exactly the residents whose journaled R̂ no longer
        re-certifies.  Per-task results are memoized on the complete
        interference context — (higher-priority (task, GN) prefix, own
        (task, GN), bus blocking from below) — so successive
        certifications (e.g. the pinned admission loop, or re-certifying
        after churn elsewhere in the set) only pay for tasks whose context
        actually changed.  ``probe`` (usually the arrival — the marginal
        task) is analyzed first so a failing candidate costs one analysis,
        not a prefix sweep.
        """
        ordered = sorted(entries, key=lambda e: e.trans_task.deadline)
        ts = TaskSet(tuple(e.trans_task for e in ordered))
        inc = RtgpuIncremental(ts, tightened=self.tightened, tables=tables,
                               preemption=self.preemption)
        vectors = transitional_vectors(ordered)
        # bus blocking below k (part of the memo key — analyze_task uses it)
        n = len(ordered)
        blocking = bus_blocking([e.trans_task for e in ordered])
        # under preemptive arbitration the GPU blocking term (one context
        # switch when any lower-priority task launches kernels) is part of
        # the interference context too, so it joins the memo key — the
        # analyzer's own list, so key and analysis can never disagree
        g_blocking = inc._gpu_blocking if self.preemption.enabled else None
        bounds: dict[str, float] = {}
        analyses = 0
        indices = list(range(n))
        if probe is not None:
            for k in indices:
                if ordered[k].task.name == probe:
                    indices.remove(k)
                    indices.insert(0, k)
                    break
        for k in indices:
            e = ordered[k]
            worst = 0.0
            for interf_vec, self_vec in vectors:
                key = _memo_key(ordered, interf_vec, self_vec, k,
                                blocking, g_blocking)
                r = memo.get(key)
                if r is None:
                    prefix = interf_vec[:k] + [self_vec[k]]
                    ta = inc.analyze_task(k, prefix)
                    analyses += 1
                    metrics.inc("certify_memo_misses_total")
                    r = ta.response if ta.schedulable else math.inf
                    memo[key] = r
                else:
                    metrics.inc("certify_memo_hits_total")
                if not math.isfinite(r):
                    if partial:
                        worst = math.inf
                        break
                    metrics.inc("certify_analyses_total", amount=analyses,
                                engine=self.name)
                    return None, analyses, f"task {e.task.name!r} unschedulable"
                worst = max(worst, r)
            bounds[e.task.name] = worst
        metrics.inc("certify_analyses_total", amount=analyses,
                    engine=self.name)
        return bounds, analyses, ""

    def warm_memo(
        self,
        ordered: Sequence[Entry],
        analysis: SetAnalysis,
        tables: AnalysisTables,
        memo: dict[tuple, float],
    ) -> None:
        """Warm the certify memo from a committed re-allocation result.

        ``realloc_search`` certifies every task at the re-balanced vector
        but bypasses the memo (it works on raw task sets, not entries);
        without this, every sweep after a re-allocation re-analyzes the
        full higher-priority prefix.  Instant mode only (one transitional
        vector): each task's response is stored under the same
        :func:`_memo_key` the sweeps read."""
        ts = TaskSet(tuple(e.trans_task for e in ordered))
        blocking = bus_blocking([e.trans_task for e in ordered])
        g_blocking = (
            RtgpuIncremental(ts, tightened=self.tightened, tables=tables,
                             preemption=self.preemption)._gpu_blocking
            if self.preemption.enabled else None
        )
        vec = [e.alloc for e in ordered]
        for k, ta in enumerate(analysis.tasks):
            r = ta.response if ta.schedulable else math.inf
            memo[_memo_key(ordered, vec, vec, k, blocking, g_blocking)] = \
                float(r)

    def _pinned_scalar(
        self,
        task: RTTask,
        residents: Sequence[Entry],
        tables: AnalysisTables,
        memo: dict[tuple, float],
        g_min: int,
        free: int,
    ) -> tuple[Optional[int], Optional[dict[str, float]], int]:
        """Pinned admission, scalar: 1-D search over the arrival's GN only."""
        residents = list(residents)
        tried = 0
        for g in range(g_min, free + 1):
            cand = Entry(task=task, alloc=g)
            tried += 1
            bounds, _, _ = self.certify(residents + [cand], tables, memo,
                                        probe=task.name)
            if bounds is not None:
                return g, bounds, tried
        return None, None, tried

    @abc.abstractmethod
    def pinned_sweep(
        self,
        task: RTTask,
        residents: Sequence[Entry],
        tables: AnalysisTables,
        memo: dict[tuple, float],
        g_min: int,
        free: int,
    ) -> tuple[Optional[int], Optional[dict[str, float]], int]:
        """Pinned admission: residents keep their slices, only the
        arrival's GN ∈ [g_min, free] is searched.  Returns ``(smallest
        feasible GN, certified bounds, candidates tried)`` or ``(None,
        None, tried)`` when every candidate fails."""

    @abc.abstractmethod
    def realloc_search(
        self,
        ts: TaskSet,
        gn_total: int,
        max_nodes: int,
        hint: Sequence[Optional[int]],
        tables: AnalysisTables,
    ) -> FederatedResult:
        """Full Algorithm 2 re-allocation, warm-started with ``hint``."""


class ScalarCertifier(CertificationEngine):
    """The per-candidate reference path (memoized scalar loop + grid DFS)."""

    name = "scalar"

    def pinned_sweep(self, task, residents, tables, memo, g_min, free):
        return self._pinned_scalar(task, residents, tables, memo, g_min, free)

    def realloc_search(self, ts, gn_total, max_nodes, hint, tables):
        return grid_search_dfs(
            ts, gn_total, tightened=self.tightened,
            max_nodes=max_nodes, hint=hint, tables=tables,
            preemption=self.preemption,
        )


class BatchCertifier(CertificationEngine):
    """Vectorized certification: batched pinned sweep + frontier search.

    Result-identical to :class:`ScalarCertifier` — the same transitional
    vectors, the same per-task envelope maxima, the same smallest feasible
    GN — but one vectorized sweep per (task, vector) instead of
    ``O(free × n)`` scalar analyses.  Below ``min_work`` (candidate GNs ×
    tasks analyzed) the memoized scalar loop's lower constant wins and the
    sweep dispatches there adaptively; both produce identical decisions
    and bounds.
    """

    name = "batch"

    def __init__(
        self,
        tightened: bool = True,
        min_work: int = 128,
        preemption: "PreemptionModel | str | None" = None,
    ):
        super().__init__(tightened=tightened, preemption=preemption)
        self.min_work = min_work

    def pinned_sweep(self, task, residents, tables, memo, g_min, free):
        n_width = (free - g_min + 1) * (len(residents) + 1)
        if n_width < self.min_work:
            return self._pinned_scalar(task, residents, tables, memo,
                                       g_min, free)
        return self._pinned_batch(task, residents, tables, memo, g_min, free)

    def _pinned_batch(
        self,
        task: RTTask,
        residents: Sequence[Entry],
        tables: AnalysisTables,
        memo: dict[tuple, float],
        g_min: int,
        free: int,
    ) -> tuple[Optional[int], Optional[dict[str, float]], int]:
        """Batched pinned admission: certify every candidate GN at once.

        Reads and warms the same certify memo as the scalar loop (keys via
        :func:`_memo_key`), so prefixes above the arrival are one lookup
        when already certified, and a later full-set :meth:`certify` of
        the admitted state re-analyzes nothing."""
        cand = Entry(task=task, alloc=g_min)
        ordered = sorted(list(residents) + [cand],
                         key=lambda e: e.trans_task.deadline)
        a = ordered.index(cand)
        ts = TaskSet(tuple(e.trans_task for e in ordered))
        ana = BatchAnalyzer(ts, tightened=self.tightened, tables=tables,
                            preemption=self.preemption)
        vectors = transitional_vectors(ordered)
        blocking = bus_blocking([e.trans_task for e in ordered])
        g_blocking = (ana.scalar._gpu_blocking if self.preemption.enabled
                      else None)
        gs = np.arange(g_min, free + 1, dtype=np.int64)
        n = len(ordered)
        worst = np.zeros((gs.size, n))
        alive = np.ones(gs.size, dtype=bool)
        for interf_vec, self_vec in vectors:
            for k in range(n):
                if not alive.any():
                    break
                row = list(interf_vec[:k]) + [self_vec[k]]
                if a > k:
                    # prefix does not involve the arrival: one lookup/analysis
                    key = _memo_key(ordered, interf_vec, self_vec, k,
                                    blocking, g_blocking)
                    r = memo.get(key)
                    if r is None:
                        da = ana.analyze_prefixes(
                            k, np.asarray([row], dtype=np.int64),
                            dedupe=False,
                        )
                        r = (float(da.response[0])
                             if bool(da.schedulable[0]) else math.inf)
                        memo[key] = r
                        metrics.inc("certify_memo_misses_total")
                    else:
                        metrics.inc("certify_memo_hits_total")
                    np.maximum(worst[:, k], r, out=worst[:, k])
                    if not math.isfinite(r):
                        alive[:] = False
                else:
                    idx = np.nonzero(alive)[0]
                    prefix = np.tile(np.asarray(row, dtype=np.int64),
                                     (idx.size, 1))
                    prefix[:, a] = gs[idx]
                    da = ana.analyze_prefixes(k, prefix)
                    r = np.where(da.schedulable, da.response, math.inf)
                    worst[idx, k] = np.maximum(worst[idx, k], r)
                    alive[idx] &= np.isfinite(r)
                    for j, c in enumerate(idx.tolist()):
                        gv = int(gs[c])
                        iv = list(interf_vec)
                        sv = list(self_vec)
                        iv[a] = sv[a] = gv
                        memo[_memo_key(ordered, iv, sv, k,
                                       blocking, g_blocking)] = float(r[j])
        sel = np.nonzero(alive)[0]
        if sel.size == 0:
            return None, None, int(gs.size)
        w = int(sel[0])
        bounds = {
            ordered[k].task.name: float(worst[w, k]) for k in range(n)
        }
        return int(gs[w]), bounds, w + 1

    def realloc_search(self, ts, gn_total, max_nodes, hint, tables):
        return grid_search_frontier(
            ts, gn_total, tightened=self.tightened,
            max_nodes=max_nodes, hint=hint, tables=tables,
            preemption=self.preemption,
        )


class PreemptiveCertifier(BatchCertifier):
    """GCAPS-style certification: priority-driven preemptive GPU slices.

    A :class:`BatchCertifier` whose analyses run under
    ``PreemptionModel("priority", ctx)`` — priority-ordered GPU
    interference plus the per-kernel preemption-overhead/blocking terms of
    ``repro_torch.core.rta`` — behind the unchanged :class:`CertificationEngine`
    interface.  Because the GPU is shared in time, admission may certify
    slice sets whose total exceeds the pool (see ``DynamicController``) —
    the capacity federated dedication wastes on mutually-exclusive
    reservations.

    Two preemption-specific fast paths replace the base engine's:

      * the pinned sweep is **fused end-to-end**
        (:meth:`~repro_torch.core.rta_batch.BatchAnalyzer.analyze_pinned`): all
        per-kernel preemptive fixed points of every (task, candidate GN)
        run in two engine calls per transitional vector — no scalar
        fallback below ``min_work``, since even narrow preemptive sweeps
        pay O(candidates × tasks) scalar kernel fixed points otherwise.
        Higher-priority residents' bounds come from the shared certify
        memo (their context excludes the arrival), written back under the
        same keys so decisions and bounds stay bit-identical to the
        scalar oracle.
      * :meth:`realloc_search` is a **per-task coordinate descent**: with
        time-shared slices there is no sum budget to enumerate, so each
        resident's GN is swept independently (one fused
        ``analyze_pinned`` tail per coordinate) until the set certifies
        or a deterministic pass over all coordinates stops improving.
    """

    name = "preemptive"
    supports_preemptive_realloc = True

    #: coordinate-descent sweep budget: each full pass re-evaluates every
    #: position, so a handful of passes either converges or never will
    _DESCENT_PASSES = 4

    def __init__(
        self, tightened: bool = True, min_work: int = 128, ctx: float = 0.0
    ):
        super().__init__(
            tightened=tightened,
            min_work=min_work,
            preemption=PreemptionModel("priority", ctx),
        )

    def pinned_sweep(self, task, residents, tables, memo, g_min, free):
        return self._pinned_fused(task, residents, tables, memo, g_min, free)

    def _pinned_fused(
        self,
        task: RTTask,
        residents: Sequence[Entry],
        tables: AnalysisTables,
        memo: dict[tuple, float],
        g_min: int,
        free: int,
    ) -> tuple[Optional[int], Optional[dict[str, float]], int]:
        """Fused pinned admission under preemptive arbitration.

        Decision-identical to the scalar loop: same smallest feasible GN,
        same certified bounds, same ``tried`` count.  Shaped so rejections
        stay near the dedicated path's cost: a **probe phase** evaluates
        only the arrival's own row for every candidate (one fused call per
        vector — the fused twin of the scalar path's probe-first trick),
        and only candidates that survive their own deadline pay for the
        tasks below them, smallest GN first, so the first survivor that
        certifies its tail is exactly the scalar loop's winner."""
        cand = Entry(task=task, alloc=g_min)
        ordered = sorted(list(residents) + [cand],
                         key=lambda e: e.trans_task.deadline)
        a = ordered.index(cand)
        ts = TaskSet(tuple(e.trans_task for e in ordered))
        ana = BatchAnalyzer(ts, tightened=self.tightened, tables=tables,
                            preemption=self.preemption)
        vectors = transitional_vectors(ordered)
        blocking = bus_blocking([e.trans_task for e in ordered])
        g_blocking = ana.scalar._gpu_blocking
        n = len(ordered)
        gs = list(range(g_min, free + 1))
        deadlines = np.array(
            [ordered[k].trans_task.deadline for k in range(a, n)]
        )

        # Tasks above the arrival: candidate-independent, one memo lookup
        # (or one single-row analysis) per (vector, task).
        hp_worst = [0.0] * a
        for interf_vec, self_vec in vectors:
            for k in range(a):
                key = _memo_key(ordered, interf_vec, self_vec, k,
                                blocking, g_blocking)
                r = memo.get(key)
                if r is None:
                    row = list(interf_vec[:k]) + [self_vec[k]]
                    da = ana.analyze_prefixes(
                        k, np.asarray([row], dtype=np.int64), dedupe=False
                    )
                    r = (float(da.response[0])
                         if bool(da.schedulable[0]) else math.inf)
                    memo[key] = r
                    metrics.inc("certify_memo_misses_total")
                else:
                    metrics.inc("certify_memo_hits_total")
                if not math.isfinite(r):
                    # a resident above the arrival fails in this mode: no
                    # candidate GN can help (scalar loop fails them all)
                    return None, None, len(gs)
                hp_worst[k] = max(hp_worst[k], r)

        # Probe: the arrival's own fixed points at every candidate GN — one
        # (C, 1) fused call per vector.  A rejected admission (the common
        # case once the pool is contended) ends here, having paid one row
        # per candidate instead of a full-set sweep.
        worst_a = np.zeros(len(gs))
        alive = np.ones(len(gs), dtype=bool)
        for interf_vec, self_vec in vectors:
            idx = np.nonzero(alive)[0]
            if idx.size == 0:
                break
            resp = ana.analyze_pinned(
                a, interf_vec, self_vec, [gs[c] for c in idx], k_hi=a
            )[:, 0]
            r = np.where(resp <= deadlines[0] + 1e-6, resp, math.inf)
            worst_a[idx] = np.maximum(worst_a[idx], r)
            alive[idx] &= np.isfinite(r)
            for j, c in enumerate(idx.tolist()):
                iv = list(interf_vec)
                sv = list(self_vec)
                iv[a] = sv[a] = gs[c]
                memo[_memo_key(ordered, iv, sv, a,
                               blocking, g_blocking)] = float(r[j])

        # Tail: the smallest surviving GN alone first (most admissions
        # succeed there, matching the scalar path's one-candidate cost),
        # then every remaining survivor in ONE batched call — the first
        # whose lower-priority tasks all certify is the scalar winner.
        sel = np.nonzero(alive)[0].tolist()
        first = True
        while sel:
            batch = sel[:1] if first and len(sel) > 1 else sel
            first = False
            gs_b = [gs[c] for c in batch]
            tail_worst = np.zeros((len(batch), n - a - 1))
            ok = np.ones(len(batch), dtype=bool)
            for interf_vec, self_vec in vectors:
                idx = np.nonzero(ok)[0]
                if idx.size == 0:
                    break
                resp = ana.analyze_pinned(
                    a, interf_vec, self_vec, [gs_b[c] for c in idx],
                    k_lo=a + 1,
                )
                r = np.where(resp <= deadlines[1:][None, :] + 1e-6,
                             resp, math.inf)
                tail_worst[idx] = np.maximum(tail_worst[idx], r)
                ok[idx] &= np.isfinite(r).all(axis=1)
                for j, c in enumerate(idx.tolist()):
                    iv = list(interf_vec)
                    sv = list(self_vec)
                    iv[a] = sv[a] = gs_b[c]
                    for k in range(a + 1, n):
                        memo[_memo_key(ordered, iv, sv, k,
                                       blocking, g_blocking)] = \
                            float(r[j, k - a - 1])
            win = np.nonzero(ok)[0]
            if win.size:
                wl = int(win[0])
                w = batch[wl]
                bounds = {
                    ordered[k].task.name: hp_worst[k] for k in range(a)
                }
                bounds[ordered[a].task.name] = float(worst_a[w])
                for k in range(a + 1, n):
                    bounds[ordered[k].task.name] = \
                        float(tail_worst[wl, k - a - 1])
                return gs[w], bounds, w + 1
            sel = sel[len(batch):]
        return None, None, len(gs)

    def realloc_search(self, ts, gn_total, max_nodes, hint, tables):
        """Coordinate descent over per-task GNs (time-shared slices).

        The grid search's sum-budget enumeration models dedicated
        capacity; under priority preemption slice holdings overlap, so
        every task independently ranges over ``[g_min, gn_total]``.
        Deterministic and cheap by construction:

          * interference flows strictly downward in priority order, so
            only coordinates ``j <= f`` (``f`` = the first failing task)
            can change task ``f``'s response — the sweep skips the rest;
          * per coordinate, moves are ranked by the failing task's row
            alone (one ``(C, 1)`` fused call); only the best strict
            improver pays a full ``j..f`` evaluation, and the remainder
            below ``f`` is evaluated once, when a move clears it;
          * a pass earns a successor only by moving the first failure
            deeper — a saturated set stops after one pass instead of
            chasing load-only wiggles."""
        n = len(ts)
        mins = []
        for t in ts:
            g = next(
                (g for g in range(1, gn_total + 1)
                 if t.min_span(2 * g) <= t.deadline + _EPS), None,
            )
            if g is None:
                return FederatedResult(False, None, None, 0)
            mins.append(g)
        ana = BatchAnalyzer(ts, tightened=self.tightened, tables=tables,
                            preemption=self.preemption)
        alloc = [
            min(max(int(hint[k]), mins[k]), gn_total)
            if hint is not None and k < len(hint) and hint[k] else mins[k]
            for k in range(n)
        ]
        D = np.array([t.deadline for t in ts])
        tried = 0

        def first_fail(arr: np.ndarray) -> int:
            bad = np.nonzero(arr > D[: arr.size] + 1e-6)[0]
            return int(bad[0]) if bad.size else arr.size

        def load_through(arr: np.ndarray, f: int) -> float:
            seg, dn = arr[: f + 1], D[: f + 1]
            return float(np.sum(np.minimum(
                np.where(np.isfinite(seg), seg, 2.0 * dn) / dn, 2.0
            )))

        def materialize(final_alloc: list[int]) -> FederatedResult:
            inc = RtgpuIncremental(ts, tightened=self.tightened,
                                   tables=tables,
                                   preemption=self.preemption)
            chain = tuple(
                inc.analyze_task(k, final_alloc[: k + 1]) for k in range(n)
            )
            return FederatedResult(
                True, tuple(final_alloc), SetAnalysis(chain), tried
            )

        # Invariant: resp[0..f] is accurate for the current alloc (the
        # suffix past f may be stale — it is re-evaluated the moment a
        # move clears every known failure).
        resp = ana.analyze_pinned(0, alloc, alloc, [alloc[0]])[0]
        tried += 1
        f = first_fail(resp)
        if f == n:
            return materialize(alloc)
        best = (-f, load_through(resp, f))
        for _ in range(self._DESCENT_PASSES):
            f_at_pass = f
            improved = False
            j = 0
            while j <= f:
                cands = list(range(mins[j], gn_total + 1))
                if tried + len(cands) > max_nodes:
                    return FederatedResult(False, None, None, tried)
                # Rank moves by the failing task's row alone — one (C, 1)
                # call — then fully evaluate only the best strict improver.
                col = ana.analyze_pinned(
                    j, alloc, alloc, cands, k_lo=f, k_hi=f
                )[:, 0]
                tried += len(cands)
                pick = None
                for c, g in enumerate(cands):
                    if col[c] < resp[f] and (
                        pick is None or col[c] < col[pick]
                    ):
                        pick = c
                if pick is not None:
                    g = cands[pick]
                    verify = ana.analyze_pinned(
                        j, alloc, alloc, [g], k_lo=j, k_hi=f
                    )[0]
                    tried += 1
                    pref = np.concatenate([resp[:j], verify])  # 0..f
                    ff = first_fail(pref)
                    if ff > f:
                        # clears every known failure: evaluate the rest
                        rest = (ana.analyze_pinned(
                                    j, alloc, alloc, [g], k_lo=f + 1)[0]
                                if f + 1 < n else np.zeros(0))
                        tried += 1 if f + 1 < n else 0
                        alloc[j] = g
                        resp = np.concatenate([pref, rest])
                        f = first_fail(resp)
                        if f == n:
                            return materialize(alloc)
                        best = (-f, load_through(resp, f))
                        improved = True
                    else:
                        sc = (-ff, load_through(pref, f))
                        if sc < best:
                            alloc[j] = g
                            resp = np.concatenate([pref, resp[f + 1:]])
                            best = sc
                            improved = True
                j += 1
            # another pass is only worth its nodes when the first failure
            # actually moved deeper — load-only wiggles never converge
            if not improved or f == f_at_pass:
                break
        return FederatedResult(False, None, None, tried)


def make_certifier(
    engine: str,
    tightened: bool = True,
    min_work: int = 128,
    preemption: "PreemptionModel | str | None" = None,
    gpu_ctx: float = 0.0,
) -> CertificationEngine:
    """Engine factory: ``"batch"`` (default controller engine), the
    ``"scalar"`` reference path, or ``"preemptive"`` (batched GCAPS-style
    certification).  A ``preemption`` model composes with either base
    engine — ``("batch", "priority")`` resolves to
    :class:`PreemptiveCertifier`."""
    pm = PreemptionModel.coerce(preemption, ctx=gpu_ctx)
    if engine == "preemptive":
        pm = pm if pm.enabled else PreemptionModel("priority", gpu_ctx)
        return PreemptiveCertifier(tightened=tightened, min_work=min_work,
                                   ctx=pm.ctx)
    if engine == "batch":
        if pm.enabled:
            return PreemptiveCertifier(tightened=tightened,
                                       min_work=min_work, ctx=pm.ctx)
        return BatchCertifier(tightened=tightened, min_work=min_work)
    if engine == "scalar":
        return ScalarCertifier(tightened=tightened, preemption=pm)
    raise ValueError(f"unknown analysis engine {engine!r}")
