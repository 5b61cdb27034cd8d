"""Algorithm 2: grid-searched federated virtual-SM allocation.

Enumerates allocations GN_i >= 1 with sum <= GN (the paper's nested loops),
running the RTGPU schedulability analysis per candidate, plus the greedy
variant mentioned in §5.5.

Three structural accelerations (results identical to the brute force):
  * **minimum viable allocation**: each task needs GN_i large enough that its
    isolated best-case span fits its deadline — loops start there;
  * **prefix DFS**: under RTGPU, task k's schedulability depends only on
    ``alloc[0..k]`` (see rta.RtgpuIncremental), so the nested loops test task
    k at depth k and prune entire subtrees on the first failing prefix;
  * **batched frontier search** (default for the RTGPU analyzers): the same
    prefix tree, explored breadth-wise with all of a depth's candidates
    analyzed in one vectorized call — see ``repro_torch.core.rta_batch``.  The
    scalar DFS remains as the reference oracle (``engine="dfs"``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, Optional, Sequence

from .rta import (
    AnalysisTables,
    PreemptionModel,
    RtgpuIncremental,
    SetAnalysis,
    TaskAnalysis,
    analyze_rtgpu,
    analyze_rtgpu_plus,
)
from .task import TaskSet

__all__ = [
    "FederatedResult",
    "min_viable_alloc",
    "iter_allocations",
    "grid_search",
    "grid_search_dfs",
    "greedy_search",
    "schedule",
]

Analyzer = Callable[[TaskSet, Sequence[int]], SetAnalysis]


@dataclasses.dataclass(frozen=True)
class FederatedResult:
    schedulable: bool
    alloc: Optional[tuple[int, ...]]
    analysis: Optional[SetAnalysis]
    candidates_tried: int


def min_viable_alloc(taskset: TaskSet, gn_total: int) -> Optional[list[int]]:
    """Per-task minimum GN_i such that the task fits its deadline in isolation.

    Necessary condition:  Σ CL̆ + Σ ML̆ + Σ GR̆(2GN_i) ≤ D_i.  Returns None
    when even GN_i = GN does not fit (set is trivially unschedulable).
    """
    mins: list[int] = []
    for task in taskset:
        lo = None
        for gn in range(1, gn_total + 1):
            if task.min_span(2 * gn) <= task.deadline:
                lo = gn
                break
        if lo is None:
            return None
        mins.append(lo)
    if sum(mins) > gn_total:
        return None
    return mins


def iter_allocations(
    mins: Sequence[int], gn_total: int
) -> Iterator[tuple[int, ...]]:
    """All allocations with alloc[i] >= mins[i] and sum(alloc) <= gn_total,
    in the paper's lexicographic nested-loop order."""
    n = len(mins)
    suffix = _suffix_mins(mins)

    def rec(i: int, remaining: int, prefix: tuple[int, ...]) -> Iterator[tuple[int, ...]]:
        if i == n:
            yield prefix
            return
        for g in range(mins[i], remaining - suffix[i + 1] + 1):
            yield from rec(i + 1, remaining - g, prefix + (g,))

    yield from rec(0, gn_total, ())


def _suffix_mins(mins: Sequence[int]) -> list[int]:
    """``suffix[i] = sum(mins[i:])`` — computed once, O(n), instead of a
    fresh ``sum(mins[k+1:])`` at every search node."""
    suffix = [0] * (len(mins) + 1)
    for i in range(len(mins) - 1, -1, -1):
        suffix[i] = mins[i] + suffix[i + 1]
    return suffix


def grid_search_dfs(
    taskset: TaskSet,
    gn_total: int,
    tightened: bool = False,
    max_nodes: int = 1_000_000,
    hint: Optional[Sequence[Optional[int]]] = None,
    tables: Optional[AnalysisTables] = None,
    preemption: "PreemptionModel | str | None" = None,
) -> FederatedResult:
    """Algorithm 2 for the RTGPU analysis, with prefix pruning.

    Visits candidate allocations in the same lexicographic order as the
    paper's nested loops and returns the same first success, but evaluates
    task k as soon as ``alloc[0..k]`` is fixed.

    Warm-start extensions (both default off, preserving the paper order):
      * ``hint`` — a previous allocation, aligned with ``taskset`` order
        (``None`` entries for tasks without history).  At each depth the
        hinted GN_i is tried first, so a taskset that changed little since
        the last search revalidates the old allocation in O(n) analyses.
      * ``tables`` — a shared :class:`AnalysisTables`, so workload staircases
        computed by earlier searches over overlapping task sets are reused.
    """
    n = len(taskset)
    mins = min_viable_alloc(taskset, gn_total)
    if mins is None:
        return FederatedResult(False, None, None, 0)
    suffix = _suffix_mins(mins)
    inc = RtgpuIncremental(taskset, tightened=tightened, tables=tables,
                           preemption=preemption)
    tried = 0
    found: list[TaskAnalysis] = []

    def depth_order(k: int, lo: int, hi_inclusive: int) -> Iterator[int]:
        h = hint[k] if hint is not None and k < len(hint) else None
        if h is not None and lo <= h <= hi_inclusive:
            yield h
            yield from (g for g in range(lo, hi_inclusive + 1) if g != h)
        else:
            yield from range(lo, hi_inclusive + 1)

    def dfs(k: int, remaining: int, prefix: tuple[int, ...]) -> Optional[tuple[int, ...]]:
        nonlocal tried
        for g in depth_order(k, mins[k], remaining - suffix[k + 1]):
            if tried >= max_nodes:
                return None
            tried += 1
            ta = inc.analyze_task(k, prefix + (g,))
            if not ta.schedulable:
                continue
            if k == n - 1:
                found.append(ta)
                return prefix + (g,)
            found.append(ta)
            sub = dfs(k + 1, remaining - g, prefix + (g,))
            if sub is not None:
                return sub
            found.pop()
        return None

    alloc = dfs(0, gn_total, ())
    if alloc is None:
        return FederatedResult(False, None, None, tried)
    return FederatedResult(True, alloc, SetAnalysis(tuple(found)), tried)


def grid_search(
    taskset: TaskSet,
    gn_total: int,
    analyzer: Analyzer = analyze_rtgpu,
    max_candidates: int = 1_000_000,
    hint: Optional[Sequence[Optional[int]]] = None,
    tables: Optional[AnalysisTables] = None,
    engine: str = "frontier",
    preemption: "PreemptionModel | str | None" = None,
) -> FederatedResult:
    """Algorithm 2 brute force for an arbitrary analyzer (used by baselines).

    For the RTGPU analyzers the search runs on the batched frontier engine
    (``repro_torch.core.rta_batch``) by default — result-identical whenever the
    ``max_candidates`` budget does not truncate the search (a truncated
    frontier and a truncated DFS may give up on different subtrees), and
    1-2 orders of magnitude more candidates/sec; ``engine="dfs"`` selects
    the scalar prefix-DFS reference path.  ``preemption`` selects the GPU
    arbitration model (the search still enumerates capacity-disjoint
    vectors: under priority arbitration the sum constraint is conservative,
    never unsound)."""
    if engine not in ("frontier", "dfs"):
        raise ValueError(f"unknown search engine {engine!r}")
    pm = PreemptionModel.coerce(preemption)
    if pm.enabled and analyzer not in (analyze_rtgpu, analyze_rtgpu_plus):
        # a custom analyzer can't receive the model — failing loud beats
        # silently certifying priority arbitration with dedicated bounds
        raise ValueError(
            "preemption-aware search requires the RTGPU analyzers"
        )
    if analyzer in (analyze_rtgpu, analyze_rtgpu_plus):
        tight = analyzer is analyze_rtgpu_plus
        if engine == "frontier":
            from .rta_batch import grid_search_frontier

            return grid_search_frontier(
                taskset, gn_total, tightened=tight,
                max_nodes=max_candidates, hint=hint, tables=tables,
                preemption=preemption,
            )
        return grid_search_dfs(
            taskset, gn_total, tightened=tight, max_nodes=max_candidates,
            hint=hint, tables=tables, preemption=preemption,
        )
    mins = min_viable_alloc(taskset, gn_total)
    if mins is None:
        return FederatedResult(False, None, None, 0)
    tried = 0
    for alloc in iter_allocations(mins, gn_total):
        tried += 1
        if tried > max_candidates:
            break
        analysis = analyzer(taskset, alloc)
        if analysis.schedulable:
            return FederatedResult(True, alloc, analysis, tried)
    return FederatedResult(False, None, None, tried)


def greedy_search(
    taskset: TaskSet,
    gn_total: int,
    analyzer: Analyzer = analyze_rtgpu,
) -> FederatedResult:
    """The paper's greedy alternative: start from the minimum viable
    allocation, repeatedly give one more SM to the task with the worst
    R̂/D ratio."""
    mins = min_viable_alloc(taskset, gn_total)
    if mins is None:
        return FederatedResult(False, None, None, 0)
    alloc = list(mins)
    tried = 0
    while True:
        tried += 1
        analysis = analyzer(taskset, alloc)
        if analysis.schedulable:
            return FederatedResult(True, tuple(alloc), analysis, tried)
        if sum(alloc) >= gn_total:
            return FederatedResult(False, None, None, tried)
        worst, worst_key = None, 1.0
        for i, ta in enumerate(analysis.tasks):
            ratio = ta.response / ta.deadline if math.isfinite(ta.response) else math.inf
            if ratio > worst_key or (worst is None and ratio > 1.0):
                worst, worst_key = i, ratio
        if worst is None:
            return FederatedResult(False, None, None, tried)
        alloc[worst] += 1


def schedule(
    taskset: TaskSet,
    gn_total: int,
    analyzer: Analyzer = analyze_rtgpu,
    mode: str = "grid",
    max_candidates: int = 1_000_000,
    hint: Optional[Sequence[Optional[int]]] = None,
    tables: Optional[AnalysisTables] = None,
    engine: str = "frontier",
    preemption: "PreemptionModel | str | None" = None,
) -> FederatedResult:
    """Entry point used by the runtime admission controller.

    ``engine`` selects the RTGPU grid-search implementation: the batched
    ``"frontier"`` (default) or the scalar ``"dfs"`` oracle."""
    pm = PreemptionModel.coerce(preemption)
    greedy_analyzer = analyzer
    if pm.enabled:
        if analyzer not in (analyze_rtgpu, analyze_rtgpu_plus):
            raise ValueError(
                "preemption-aware scheduling requires the RTGPU analyzers"
            )

        def greedy_analyzer(ts_, alloc_, _base=analyzer):
            # bind the arbitration model so the greedy path certifies the
            # same analysis the grid paths do
            return _base(ts_, alloc_, preemption=pm)

    if mode == "grid":
        return grid_search(taskset, gn_total, analyzer, max_candidates,
                           hint=hint, tables=tables, engine=engine,
                           preemption=preemption)
    if mode == "greedy":
        return greedy_search(taskset, gn_total, greedy_analyzer)
    if mode == "greedy+grid":
        res = greedy_search(taskset, gn_total, greedy_analyzer)
        if res.schedulable:
            return res
        return grid_search(taskset, gn_total, analyzer, max_candidates,
                           hint=hint, tables=tables, engine=engine,
                           preemption=preemption)
    raise ValueError(f"unknown mode {mode!r}")
