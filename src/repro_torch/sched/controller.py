"""Online admission / mode-change controller for RTGPU federated scheduling.

The one-shot pipeline (Algorithm 2 → admit → run) assumed a frozen task
set.  A serving cluster churns: model services arrive, depart, and change
their request rate while admitted tasks keep hard deadlines.  This module
is the *protocol layer* of the scheduling stack — it sequences WHEN state
may change, delegating WHO holds capacity to the
:class:`~repro_torch.sched.capacity.SlicePool` ledger and WHETHER a state is
safe to the :mod:`repro_torch.sched.certify` engines:

  capacity.py   transactional slice ledger (reserve / commit / reclaim,
                fork-and-adopt transactions)
  certify.py    CertificationEngine — scalar pinned loop, batched sweep,
                transitional-envelope construction, realloc search
  controller.py (this file) the job-boundary mode-change protocol
  federation.py CapacityBroker — multi-host admission over N controllers

**Mode-change protocol.**  Reconfiguration never touches a job in flight:

  * a departing task keeps its virtual-SM slices until its current job's
    *boundary* (:meth:`DynamicController.job_boundary`); only then is its
    capacity reclaimed and handed to arrivals;
  * a rate change is *staged* and committed at the task's next job
    boundary — until every stager commits, the system is in a
    *transitional* mode spanning the old and new configurations.
    (Allocation re-balancing commits instantly and is therefore only
    offered by instant-transition front doors; staged boundary-mode
    re-allocation is a ROADMAP item — the ``staged_alloc`` envelope
    plumbing in capacity.py is ready for it but currently never
    populated;)
  * an arrival is admitted only if the **transitional set** — active tasks,
    not-yet-reclaimed departers, stagers at their envelope of old/new
    parameters, plus the newcomer — passes the full RTGPU analysis, so no
    admitted task can miss a deadline *during* reconfiguration (see
    :func:`repro_torch.sched.certify.transitional_vectors` for the envelope).

**Warm-start incremental re-allocation.**  Admission first tries the
*pinned* path — every resident task keeps its slices and only the arrival's
GN is searched — which costs O(free capacity) incremental analyses instead
of a full grid search.  Only if that fails (and ``allow_realloc``) does it
fall back to the full Algorithm 2 search, warm-started with the previous
allocation as a ``hint`` and the persistent
:class:`~repro_torch.core.rta.AnalysisTables` view cache, so unchanged
(task, GN) workload staircases are never rebuilt.  ``benchmarks/
churn_acceptance.py`` measures the speedup versus the cold grid search.

All mutating operations are transactional: the ledger and the view cache
are forked, and only a *successful* decision adopts the forks — a rejected
``admit()`` leaves the controller state (allocation map, bounds, analysis
cache) byte-identical, which ``tests/test_sched.py`` asserts.

**Batched certification (default).**  With ``engine="batch"`` the pinned
admission sweep runs through :class:`repro_torch.core.rta_batch.BatchAnalyzer`
(all candidate GNs certified per vectorized task sweep) and the
re-allocation fallback through ``grid_search_frontier``; decisions,
allocations, and certified R̂ bounds are identical to ``engine="scalar"``
(asserted over churn traces in ``tests/test_rta_batch.py``), the latency
is not (``benchmarks/rta_throughput.py``).  One caveat: when the realloc
search is *truncated* by ``max_candidates``, the frontier and the DFS may
give up on different subtrees, so cross-engine identity is guaranteed
only for non-truncated searches (the same caveat the scalar engine's own
budget already carries for decision stability across budget values).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

from repro_torch.core import (
    AnalysisTables,
    PreemptionModel,
    RTTask,
    TaskSet,
)
from repro_torch.core.rta import RtgpuIncremental, SetAnalysis
from repro_torch.obs import metrics

from .capacity import Entry, SlicePool
from .certify import MemoOverlay, make_certifier
from .journal import task_to_dict
from .trace import EventTrace

__all__ = ["SchedDecision", "DynamicController"]

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class SchedDecision:
    """Outcome of one controller operation (admit / update_rate)."""

    admitted: bool
    alloc: Optional[dict[str, int]]          # target GN per task (post-commit)
    bounds: Optional[dict[str, float]]       # certified R̂ per task
    reason: str = ""
    path: str = ""                           # "pinned" | "realloc" | "update"
    tried: int = 0                           # candidate vectors analyzed


class DynamicController:
    """Online admission + mode-change control over ``gn_total`` SM slices.

    ``transition="boundary"`` (default) enforces the job-boundary protocol
    above; the runtime must call :meth:`job_boundary` when a task's job
    completes.  ``transition="instant"`` commits every change immediately —
    the correct semantics for *pre-runtime* admission where no job is in
    flight (the static :class:`repro_torch.runtime.AdmissionController` wraps
    this mode).
    """

    def __init__(
        self,
        gn_total: int,
        tightened: bool = True,
        transition: str = "boundary",
        allow_realloc: bool = True,
        max_candidates: int = 2000,
        trace: Optional[EventTrace] = None,
        engine: str = "batch",
        preemption: "PreemptionModel | str | None" = None,
        gpu_ctx_overhead: float = 0.0,
        journal=None,
    ):
        if transition not in ("boundary", "instant"):
            raise ValueError(f"unknown transition mode {transition!r}")
        self.gn_total = gn_total
        self.tightened = tightened
        self.transition = transition
        self.allow_realloc = allow_realloc
        self.max_candidates = max_candidates
        self.trace = trace
        # Write-ahead journal (repro_torch.sched.journal.Journal or a host-scoped
        # view).  When set, every state-changing transaction is durably
        # recorded BEFORE the in-memory commit, so a crashed controller is
        # rebuilt bit-identically by repro_torch.sched.recovery.  None (default)
        # keeps the controller purely in-memory — zero overhead, byte-
        # identical decisions and traces.
        self.journal = journal
        # GPU arbitration model.  "none" (default) is federated dedication:
        # slice holdings are capacity-disjoint and kernels never contend.
        # "priority" certifies GCAPS-style preemptive GPU slices: kernels
        # time-share the accelerator priority-driven (the runtime charges
        # gpu_ctx_overhead per preemption), so admission may hand out
        # OVERLAPPING slice sets — each task's GN is bounded by gn_total
        # alone, not by the sum constraint — and the analysis carries the
        # added interference/blocking terms instead.
        self.preemption = PreemptionModel.coerce(preemption,
                                                 ctx=gpu_ctx_overhead)
        if engine == "preemptive" and not self.preemption.enabled:
            # the engine name is itself an opt-in: keep the model the
            # certifier, the capacity rule, and the runtime all read in
            # agreement with it
            self.preemption = PreemptionModel("priority", gpu_ctx_overhead)
        # "batch" (default) certifies the pinned admission sweep with the
        # vectorized analyzer (repro_torch.core.rta_batch) and re-allocates via
        # the frontier grid search; "scalar" keeps the per-candidate
        # reference path.  Decisions and certified bounds are identical
        # (tests/test_rta_batch.py replays churn traces on both).
        self.engine = engine
        self._certifier = make_certifier(
            engine, tightened=tightened, min_work=self._BATCH_MIN_WORK,
            preemption=self.preemption,
        )
        if journal is not None:
            # the semantic config the journaled bounds were certified under;
            # re-opening the journal with a different one is an error
            journal.ensure_meta(
                f"host{getattr(journal, 'host', None) or 0}",
                self.journal_config(),
            )
        self._pool = SlicePool(gn_total)
        self._bounds: dict[str, float] = {}
        self._tables = AnalysisTables()
        # Memoized per-task certification, shared with the certifier: key =
        # the complete interference context of one analyze_task call —
        # (prefix (task, GN) pairs, own (task, GN), bus blocking from
        # below) — value = R̂ (inf when unschedulable).
        self._memo: dict[tuple, float] = {}
        # Re-allocation backoff (preemptive arbitration): pool fingerprints
        # whose coordinate-descent search already came up empty.  A failed
        # search is a property of the saturated resident state, so repeat
        # arrivals against the unchanged pool skip straight to rejection;
        # any admit/release/re-size changes the fingerprint and re-arms
        # the search.  Bounded FIFO — an evicted entry only costs a redo.
        self._realloc_futile: dict[tuple, None] = {}
        # Capacity-change listeners: zero-argument callables fired after
        # any committed change to this host's envelope capacity (admit,
        # reclaim, boundary commit, restore).  The broker subscribes one
        # per host to keep its fleet-wide free-capacity array incremental
        # — correct even when callers mutate a host directly rather than
        # through the broker.
        self._capacity_listeners: list = []
        self.epoch = 0

    # Pinned-sweep crossover: (candidate GNs x tasks analyzed) above which
    # the vectorized certification beats the memoized scalar loop (measured
    # ~6x faster at 26 residents / 32 slices, ~5x slower at 5 residents /
    # 10 slices — NumPy dispatch constants dominate tiny systems).
    _BATCH_MIN_WORK = 128

    # Caches are keyed by departed tasks forever if left unbounded; a
    # long-lived controller would leak and pay O(history) dict copies per
    # admission.  Crude generational eviction keeps both transactional
    # copies and memory O(limit); a cleared cache only costs re-analysis.
    _MEMO_LIMIT = 20_000
    _TABLES_LIMIT = 4_000

    def _trim_caches(self) -> None:
        if len(self._memo) > self._MEMO_LIMIT:
            self._memo.clear()
        if len(self._tables) > self._TABLES_LIMIT:
            self._tables.adopt(AnalysisTables())

    # ---- capacity-change notification ---------------------------------------

    def add_capacity_listener(self, fn) -> None:
        """Subscribe a zero-argument callable to committed capacity
        changes (fired after the change lands, so reads inside the
        callback see the new state)."""
        self._capacity_listeners.append(fn)

    def _notify_capacity(self) -> None:
        for fn in self._capacity_listeners:
            fn()

    # ---- introspection ------------------------------------------------------

    @property
    def pool(self) -> SlicePool:
        """The slice ledger (read-only for external layers: the broker
        inspects entries to pick migration candidates)."""
        return self._pool

    @property
    def allocation(self) -> dict[str, int]:
        """Committed GN per resident task (slices physically held now)."""
        return self._pool.allocation

    @property
    def target_allocation(self) -> dict[str, int]:
        """GN per task once every staged change commits."""
        return self._pool.target_allocation

    @property
    def capacity_in_use(self) -> int:
        return self._pool.capacity_in_use

    @property
    def free_capacity(self) -> int:
        return self._pool.free_capacity

    @property
    def tables(self) -> AnalysisTables:
        """The shared (task, GN) → workload-table cache; external analyses
        over the resident set can pass this to RtgpuIncremental to stay
        warm."""
        return self._tables

    def bounds(self) -> dict[str, float]:
        """Certified analytic R̂ per resident task (transitional envelope)."""
        return dict(self._bounds)

    def bound(self, name: str) -> float:
        return self._bounds.get(name, math.inf)

    def order(self) -> list[str]:
        """Current fixed-priority order (deadline-monotonic over the
        transitional set; index 0 = highest priority)."""
        ordered = sorted(
            self._pool.entries(), key=lambda e: e.trans_task.deadline
        )
        return [e.task.name for e in ordered]

    def is_departing(self, name: str) -> bool:
        e = self._pool.get(name)
        return bool(e and e.departing)

    def in_transition(self, name: str) -> bool:
        e = self._pool.get(name)
        return bool(e and e.in_transition)

    def task(self, name: str) -> Optional[RTTask]:
        e = self._pool.get(name)
        return e.task if e else None

    def current_taskset(self) -> Optional[TaskSet]:
        if not len(self._pool):
            return None
        return TaskSet.deadline_monotonic(
            [e.task for e in self._pool.entries()]
        )

    def set_analysis(self) -> Optional[SetAnalysis]:
        """Per-task :class:`~repro_torch.core.rta.TaskAnalysis` products for the
        committed set at the committed allocation.

        This is the analysis admission already certified, re-materialized
        as full analysis objects: sharing the controller's warm view
        tables makes it O(n) fixed points, not a cold re-analysis.  The
        static :class:`repro_torch.runtime.AdmissionController` wrapper attaches
        this to its decisions instead of re-deriving the analysis itself.
        """
        ts = self.current_taskset()
        if ts is None:
            return None
        alloc = self.allocation
        alloc_list = [alloc[t.name] for t in ts]
        inc = RtgpuIncremental(
            ts, tightened=self.tightened, tables=self._tables,
            preemption=self.preemption,
        )
        return SetAnalysis(tuple(
            inc.analyze_task(k, alloc_list) for k in range(len(ts))
        ))

    def journal_config(self) -> dict:
        """The semantic configuration journaled as this controller's meta
        scope: everything that determines what a journaled R̂ *means*.
        (Engine choice is excluded on purpose — scalar and batched
        certification are bound-identical, so either may replay the
        other's journal.)"""
        return {
            "gn_total": self.gn_total,
            "tightened": self.tightened,
            "transition": self.transition,
            "preemption": self.preemption.mode,
            "gpu_ctx_overhead": self.preemption.ctx,
        }

    def restore(self, entries, bounds: dict[str, float], epoch: int) -> None:
        """Install recovered state (see :mod:`repro_torch.sched.recovery`).

        Only valid on a fresh controller: recovery rebuilds the ledger
        from the journal and re-certifies it, then hands the result here.
        Entry order is preserved (it is the deadline-monotonic stable-sort
        tiebreak, so it must match the pre-crash admit order)."""
        if len(self._pool):
            raise RuntimeError("restore() requires a fresh controller")
        pool = SlicePool(self.gn_total)
        for e in entries:
            pool.reserve(e.copy())
        self._pool = pool
        self._bounds = dict(bounds)
        self.epoch = int(epoch)
        self._notify_capacity()

    def fingerprint(self) -> tuple:
        """Hashable snapshot of ALL mutable controller state — the ledger,
        bounds, analysis caches, epoch."""
        return (
            self._pool.fingerprint(),
            tuple(sorted(self._bounds.items())),
            self._tables.fingerprint(),
            frozenset(self._memo),
            self.epoch,
        )

    # ---- operations ---------------------------------------------------------

    def admit(
        self,
        task: RTTask,
        t: float = 0.0,
        allow_realloc: Optional[bool] = None,
        pinned: bool = True,
    ) -> SchedDecision:
        """Admit ``task`` against the transitional set, or reject untouched.

        Pinned warm path first (residents keep their slices; only the
        arrival's GN is searched over reclaimed-free capacity), then the
        warm-started full grid search if ``allow_realloc``.  The keywords
        narrow (never widen) the constructor setting per call — the
        :class:`~repro_torch.sched.CapacityBroker` uses ``allow_realloc=False``
        for its cheap first placement pass across hosts, then
        ``pinned=False`` on the targeted second pass: rejection is
        transactional, so a pinned sweep that failed in pass one would
        fail identically and needn't be repeated before the re-balance
        search.
        """
        with metrics.timed("sched_admit_latency_ms"):
            dec = self._admit(task, t, allow_realloc, pinned)
        metrics.inc("sched_admit_total",
                    result="admitted" if dec.admitted else "rejected",
                    path=dec.path or "none")
        metrics.observe("sched_admit_candidates", dec.tried,
                        buckets=metrics.DEFAULT_RESPONSE_BUCKETS)
        return dec

    def _admit(
        self,
        task: RTTask,
        t: float,
        allow_realloc: Optional[bool],
        pinned: bool,
    ) -> SchedDecision:
        name = task.name
        if not name:
            return self._reject(task, t, "task must have a name")
        if name in self._pool:
            return self._reject(task, t, f"name {name!r} already resident")

        # Capacity the arrival's GN may range over.  Federated dedication:
        # the reclaimed-free slices only.  Priority preemption: slices are
        # shared in time, so the arrival may hold up to the whole pool
        # regardless of residents' (overlapping) holdings — schedulability
        # is policed by the preemptive analysis terms, not by disjointness.
        free = self.gn_total if self.preemption.enabled \
            else self.free_capacity
        g_min = None
        for g in range(1, free + 1):
            if task.min_span(2 * g) <= task.deadline + _EPS:
                g_min = g
                break
        tried = 0
        fork = self._tables.fork()
        # copy-on-write: reads hit the shared memo, writes stay private
        # until commit — no O(memo) snapshot per admission attempt
        memo = MemoOverlay(self._memo)
        pool = self._pool.fork()
        residents = pool.entries()
        spans = self.trace is not None and getattr(self.trace, "spans", False)

        if g_min is not None and pinned:
            t0 = time.perf_counter() if spans else 0.0
            g_sel, bounds, tried = self._certifier.pinned_sweep(
                task, residents, fork, memo, g_min, free
            )
            if spans:
                self.trace.span(
                    t, "pinned_sweep", (time.perf_counter() - t0) * 1e3,
                    target=name, tried=tried,
                    hit=g_sel is not None,
                )
            metrics.inc("sched_pinned_sweeps_total",
                        result="hit" if g_sel is not None else "miss")
            if g_sel is not None:
                cand = Entry(task=task, alloc=g_sel)
                return self._commit_admit(cand, bounds, pool, fork, memo, t,
                                          path="pinned", tried=tried)

        # Full re-allocation only helps the *instant* front door: under the
        # boundary protocol a shrinking resident keeps max(old, new) slices
        # until its job boundary, so re-allocating can never hand an arrival
        # capacity the pinned path didn't already have.  Under priority
        # preemption the sum-budget grid search models dedicated capacity,
        # not time-shared slices, so the fallback runs only for engines
        # whose realloc_search understands overlapping holdings (the
        # preemptive certifier's per-task coordinate descent): re-sizing a
        # resident's slice count reshapes its occupancy interference, which
        # CAN unblock an arrival the pinned sweep rejects.
        realloc_ok = (self.allow_realloc if allow_realloc is None
                      else self.allow_realloc and allow_realloc)
        realloc_ran = False
        realloc_backoff = False
        if realloc_ok and self.transition == "instant" \
                and (not self.preemption.enabled
                     or self._certifier.supports_preemptive_realloc):
            # Backoff: a failed preemptive descent certifies the *resident*
            # state as saturated, so repeat arrivals against the unchanged
            # pool skip the search.  Conservative only — it can reject an
            # arrival a fresh search would admit, never the reverse.
            fp = (self._pool.fingerprint()
                  if self.preemption.enabled else None)
            if fp is not None and fp in self._realloc_futile:
                metrics.inc("sched_realloc_skips_total")
                realloc_backoff = True
            else:
                t0 = time.perf_counter() if spans else 0.0
                dec, dfs_tried = self._admit_realloc(
                    task, pool, fork, memo, t, tried
                )
                if spans:
                    self.trace.span(
                        t, "grid_search", (time.perf_counter() - t0) * 1e3,
                        target=name, tried=dfs_tried, hit=dec is not None,
                    )
                if dec is not None:
                    return dec
                if fp is not None:
                    self._realloc_futile[fp] = None
                    while len(self._realloc_futile) > 16:
                        self._realloc_futile.pop(
                            next(iter(self._realloc_futile)))
                tried += dfs_tried
                realloc_ran = True

        if realloc_ran:
            reason = (
                "unschedulable under pinned and re-balanced allocations"
                + (" (search truncated)" if tried >= self.max_candidates
                   else "")
            )
        elif realloc_backoff:
            reason = ("unschedulable under pinned allocations; re-balance "
                      "skipped (resident set already certified saturated)")
        elif g_min is None:
            reason = "no feasible GN within free capacity"
        else:
            reason = "transitional set unschedulable under every candidate allocation"
        return self._reject(task, t, reason, tried=tried)

    def _admit_realloc(
        self,
        task: RTTask,
        pool: SlicePool,
        fork: AnalysisTables,
        memo: MemoOverlay,
        t: float,
        tried0: int,
    ) -> tuple[Optional[SchedDecision], int]:
        """Warm-started full re-allocation (Algorithm 2 with hint + tables).

        Instant mode only: with no jobs in flight the whole allocation may
        be re-balanced at once.  The search is seeded with the incumbent
        allocation as its ``hint`` and shares the persistent view tables,
        so a near-unchanged task set revalidates in O(n) analyses instead
        of re-running Algorithm 2 from scratch.

        Returns ``(decision, nodes_tried)``; the node count is reported
        even on failure so callers can tell a truncated search from an
        exhausted one."""
        residents = pool.entries()
        cand_entry = Entry(task=task, alloc=0)
        ordered = sorted(
            residents + [cand_entry], key=lambda e: e.trans_task.deadline
        )
        ts = TaskSet(tuple(e.trans_task for e in ordered))
        hint = [
            e.gn_hi if e is not cand_entry else None for e in ordered
        ]
        fed = self._certifier.realloc_search(
            ts, self.gn_total, max_nodes=self.max_candidates, hint=hint,
            tables=fork,
        )
        if not fed.schedulable:
            return None, fed.candidates_tried
        new_gn = {e.task.name: g for e, g in zip(ordered, fed.alloc)}
        for e in residents:
            # through the pool API so the incremental capacity counter
            # tracks the re-size (the candidate isn't reserved yet)
            pool.set_alloc(e.task.name, new_gn[e.task.name])
        cand_entry.alloc = new_gn[task.name]
        bounds = {ta.name: ta.response for ta in fed.analysis.tasks}
        # re-balanced bounds into the certify memo: the next sweep's
        # higher-priority prefix is lookups, not a full re-analysis
        self._certifier.warm_memo(ordered, fed.analysis, fork, memo)
        return self._commit_admit(
            cand_entry, bounds, pool, fork, memo, t, path="realloc",
            tried=tried0 + fed.candidates_tried,
        ), fed.candidates_tried

    def _commit_admit(
        self,
        cand: Entry,
        bounds: dict[str, float],
        pool: SlicePool,
        fork: AnalysisTables,
        memo: MemoOverlay,
        t: float,
        path: str,
        tried: int,
    ) -> SchedDecision:
        if self.journal is not None:
            # write-ahead: the certified decision is durable before any
            # in-memory state changes.  The payload carries everything
            # replay needs — the task spec, its GN, the full post-op
            # allocation map (a realloc commit re-sizes residents too),
            # the certified bounds and the post-op epoch.
            self.journal.append(
                "admit", cand.task.name, t=t,
                spec=task_to_dict(cand.task), gn=cand.alloc, path=path,
                alloc={e.task.name: e.alloc for e in pool.entries()},
                bounds=bounds, epoch=self.epoch + 1,
            )
        pool.reserve(cand)
        self._pool.adopt(pool)
        self._bounds = bounds
        self._tables.adopt(fork)
        memo.flush_into(self._memo)
        self._trim_caches()
        self.epoch += 1
        self._notify_capacity()
        if self.trace is not None:
            self.trace.record(
                t, "admit", cand.task.name, gn=cand.alloc, path=path,
                bound=round(bounds[cand.task.name], 6),
            )
            if path == "realloc":
                self.trace.record(t, "realloc", cand.task.name,
                                  target={k: v for k, v in
                                          self.target_allocation.items()})
        return SchedDecision(
            admitted=True,
            alloc=self.target_allocation,
            bounds=dict(bounds),
            path=path,
            tried=tried,
        )

    def _reject(
        self, task: RTTask, t: float, reason: str, tried: int = 0
    ) -> SchedDecision:
        if self.trace is not None:
            self.trace.record(t, "reject", task.name or "?", reason=reason)
        return SchedDecision(False, None, None, reason=reason, tried=tried)

    def release(self, name: str, t: float = 0.0) -> bool:
        """Begin removing ``name``.  Boundary mode marks it *departing* —
        its slices stay allocated (and it stays in every transitional
        analysis) until :meth:`job_boundary` reclaims them.  Instant mode
        reclaims immediately.  Removal never needs a schedulability test."""
        e = self._pool.get(name)
        if e is None or e.departing:
            return False
        if self.transition == "instant":
            if self.journal is not None:
                self.journal.append("release", name, t=t,
                                    epoch=self.epoch + 1)
            self._reclaim(name, t)
            return True
        if self.journal is not None:
            self.journal.append("depart", name, t=t)
        self._pool.mark_departing(name)
        if self.trace is not None:
            self.trace.record(t, "depart", name, gn=e.alloc)
        return True

    def _reclaim(self, name: str, t: float) -> None:
        e = self._pool.reclaim(name)
        self._bounds.pop(name, None)
        self.epoch += 1
        metrics.inc("sched_reclaim_total")
        self._notify_capacity()
        if self.trace is not None:
            self.trace.record(t, "reclaim", name, gn=e.alloc)

    def job_boundary(self, name: str, t: float = 0.0) -> str:
        """Runtime hook: ``name`` just completed a job (or is idle).

        Returns ``"reclaimed"`` (departing task fully removed, slices back
        in the pool), ``"committed"`` (staged allocation / rate change took
        effect), or ``"none"``."""
        e = self._pool.get(name)
        if e is None:
            return "none"
        if e.departing:
            if self.journal is not None:
                self.journal.append("boundary", name, t=t,
                                    result="reclaimed", epoch=self.epoch + 1)
            self._reclaim(name, t)
            return "reclaimed"
        if e.in_transition:
            if self.journal is not None:
                self.journal.append("boundary", name, t=t,
                                    result="committed")
            self._pool.commit(name)   # envelope surplus returns to the pool
            self._notify_capacity()
            if self.trace is not None:
                self.trace.record(t, "realloc", name, committed=e.alloc)
            return "committed"
        return "none"

    def update_rate(
        self, name: str, period: float, deadline: float, t: float = 0.0
    ) -> SchedDecision:
        """Mode change: re-rate ``name`` to (T, D), keeping its segments.

        Certified against the transitional envelope (min T, min D while old
        and new jobs can coexist); committed at the task's next job
        boundary (boundary mode) or immediately (instant mode).  Rejection
        leaves the old rate — and all controller state — untouched."""
        e = self._pool.get(name)
        if e is None:
            return SchedDecision(False, None, None,
                                 reason=f"no resident task {name!r}")
        if e.departing:
            return SchedDecision(False, None, None,
                                 reason=f"task {name!r} is departing")
        try:
            new_task = dataclasses.replace(
                e.target_task, period=period, deadline=deadline
            )
        except ValueError as err:
            return SchedDecision(False, None, None, reason=str(err))

        pool = self._pool.fork()
        cands = pool.entries()
        cand = next(c for c in cands if c.task.name == name)
        if self.transition == "instant":
            # no jobs span the switch: certify the pure new-parameter set
            # (the min(T)/min(D) envelope would spuriously reject mixed
            # changes like a longer deadline with a shorter period)
            cand.task = new_task
            cand.staged_task = None
        else:
            cand.staged_task = new_task
        fork = self._tables.fork()
        memo = MemoOverlay(self._memo)
        spans = self.trace is not None and getattr(self.trace, "spans", False)
        t0 = time.perf_counter() if spans else 0.0
        with metrics.timed("sched_update_latency_ms"):
            bounds, analyses, reason = self._certifier.certify(
                cands, fork, memo, probe=name
            )
        if spans:
            self.trace.span(
                t, "certify", (time.perf_counter() - t0) * 1e3,
                target=name, tried=analyses, hit=bounds is not None,
            )
        metrics.inc("sched_update_total",
                    result="admitted" if bounds is not None else "rejected")
        if bounds is None:
            return SchedDecision(
                False, None, None, tried=analyses,
                reason=f"rate change unschedulable: {reason}",
            )
        if self.journal is not None:
            self.journal.append(
                "update", name, t=t, period=period, deadline=deadline,
                staged=self.transition != "instant",
                bounds=bounds, epoch=self.epoch + 1,
            )
        self._pool.adopt(pool)
        self._bounds = bounds
        self._tables.adopt(fork)
        memo.flush_into(self._memo)
        self._trim_caches()
        self.epoch += 1
        # a committed rate change re-deadlines the entry, which reorders
        # the deadline-sorted priority list — capacity listeners now fire
        # on *every* committed mutation (admit, reclaim, boundary commit,
        # rate change), the completeness the runtime's incremental
        # arbitration index relies on
        self._notify_capacity()
        if self.trace is not None:
            extra = {}
            if metrics.enabled():
                # obs-gated enrichment: the report CLI / BoundMonitor can
                # then track R̂ from the trace alone.  Off by default so
                # the golden corpus stays byte-identical.
                extra = {"bound": round(bounds[name], 6), "gn": cand.alloc}
            self.trace.record(t, "update", name, period=period,
                              deadline=deadline, **extra)
        return SchedDecision(
            admitted=True,
            alloc=self.target_allocation,
            bounds=dict(bounds),
            path="update",
            tried=analyses,
        )
