"""RTGPU response-time analysis (paper §5.2–§5.5).

Federated scheduling on virtual SMs (Lemma 5.1) + fixed-priority scheduling
of the non-preemptive bus (Lemmas 5.2/5.3) and the preemptive uniprocessor
(Lemmas 5.4/5.5), combined into the end-to-end bound of Theorem 5.6.

Two entry points:
  * ``analyze_rtgpu(taskset, alloc)`` — one-shot analysis of an allocation.
  * ``RtgpuIncremental`` — per-task incremental analysis used by the
    grid-search DFS in federated.py.  Key structural fact it exploits:
    under RTGPU, task k's schedulability depends only on ``alloc[0..k]``
    (GPU segments are dedicated; bus/CPU interference comes from
    higher-priority tasks; bus blocking uses lower-priority ML̂ only,
    which is allocation-independent).

This module is the *scalar reference oracle*: every recurrence is evaluated
one candidate at a time in plain Python, exactly as printed in the paper.
``repro_torch.core.rta_batch`` evaluates the same Lemma 5.3/5.5 fixed points for
whole frontiers of candidate allocations at once over the staircase arrays
exported by :meth:`repro_torch.core.workload.ViewTables.as_arrays`; its results
are asserted identical to this path (tests/test_rta_batch.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

from .task import RTTask, TaskSet
from .workload import ViewTables, cpu_view, gpu_view, mem_view

__all__ = [
    "fixed_point",
    "bus_blocking",
    "gpu_blocking",
    "PreemptionModel",
    "TaskAnalysis",
    "SetAnalysis",
    "AnalysisTables",
    "analyze_rtgpu",
    "analyze_rtgpu_plus",
    "RtgpuIncremental",
]

_INF = math.inf
_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class PreemptionModel:
    """GPU arbitration model threaded through every analysis layer.

    ``mode="none"`` (default) is the paper's federated assumption: every
    task owns dedicated virtual SMs, GPU segments are contention-free by
    construction, and the analysis reduces to Lemma 5.1 verbatim.

    ``mode="priority"`` is the GCAPS-style shared accelerator
    (arXiv:2406.05221): one *preemptive priority-driven* GPU execution
    context per host.  A kernel still runs at the speed of its own
    ``2·GN`` interleave lanes (Lemma 5.1), but only the highest-priority
    ready kernel occupies the GPU at any instant — slices are shared in
    time, so allocations need not be capacity-disjoint.  ``ctx`` is the
    context-switch (preempt/resume) overhead charged per preemption.
    """

    mode: str = "none"          # "none" | "priority"
    ctx: float = 0.0            # context-switch overhead per preemption

    def __post_init__(self) -> None:
        if self.mode not in ("none", "priority"):
            raise ValueError(f"unknown preemption mode {self.mode!r}")
        if self.ctx < 0.0:
            raise ValueError("negative context-switch overhead")

    @property
    def enabled(self) -> bool:
        return self.mode == "priority"

    @staticmethod
    def coerce(
        spec: "PreemptionModel | str | None", ctx: float = 0.0
    ) -> "PreemptionModel":
        """Normalize a user-facing spec (``"none"``/``"priority"`` strings,
        an existing model, or None) into a :class:`PreemptionModel`."""
        if spec is None:
            return PreemptionModel()
        if isinstance(spec, PreemptionModel):
            return spec
        return PreemptionModel(mode=spec, ctx=ctx)


def bus_blocking(tasks: Sequence[RTTask]) -> list[float]:
    """Non-preemptive bus blocking per priority level (Lemma 5.3's B term).

    ``out[k]`` is the longest memory copy of any *lower-priority* task —
    a suffix maximum, computed in one O(n) reverse pass (allocation-free).
    """
    n = len(tasks)
    out = [0.0] * n
    acc = 0.0
    for k in range(n - 1, -1, -1):
        out[k] = acc
        if tasks[k].n_mem:
            acc = max(acc, max(tasks[k].mem_hi))
    return out


def gpu_blocking(tasks: Sequence[RTTask], ctx: float) -> list[float]:
    """Preemptive-GPU blocking per priority level (GCAPS-style B^g term).

    ``out[k]`` bounds the non-preemptible lower-priority GPU occupancy that
    can delay task k's kernels: under priority-driven arbitration a
    lower-priority kernel in flight is preempted immediately, but evicting
    it costs one context switch — so the blocking is ``ctx`` whenever any
    lower-priority task launches kernels at all, else 0 (allocation-free,
    like :func:`bus_blocking`)."""
    n = len(tasks)
    out = [0.0] * n
    any_gpu = False
    for k in range(n - 1, -1, -1):
        out[k] = ctx if any_gpu else 0.0
        if tasks[k].n_gpu:
            any_gpu = True
    return out


def fixed_point(
    base: float,
    interference: Callable[[float], float],
    limit: float,
    max_iters: int = 10_000,
) -> float:
    """Smallest fixed point of  x = base + interference(x)  (≤ limit).

    ``interference`` must be monotonically non-decreasing; iterating from
    ``base`` converges to the least fixed point.  Returns ``inf`` once the
    iterate exceeds ``limit`` (the paper only needs R̂ ≤ D)."""
    if base > limit:
        return _INF
    x = base
    for _ in range(max_iters):
        nx = base + interference(x)
        if nx > limit:
            return _INF
        if nx <= x + _EPS:
            return nx
        x = nx
    return _INF


@dataclasses.dataclass(frozen=True)
class TaskAnalysis:
    """Analysis products for one task under one allocation."""

    name: str
    n_vsm: int
    gpu_resp_lo: tuple[float, ...]
    gpu_resp_hi: tuple[float, ...]
    mem_resp_hi: tuple[float, ...]
    cpu_resp_hi: tuple[float, ...]
    r1: float
    r2: float
    deadline: float

    @property
    def response(self) -> float:
        """Theorem 5.6: R̂ = min(R̂1, R̂2)."""
        return min(self.r1, self.r2)

    @property
    def schedulable(self) -> bool:
        """Corollary 5.6.1."""
        return self.response <= self.deadline + 1e-6


@dataclasses.dataclass(frozen=True)
class SetAnalysis:
    tasks: tuple[TaskAnalysis, ...]

    @property
    def schedulable(self) -> bool:
        return all(t.schedulable for t in self.tasks)

    @property
    def responses(self) -> tuple[float, ...]:
        return tuple(t.response for t in self.tasks)


class AnalysisTables:
    """Persistent ``(task, GN) -> ViewTables`` cache shared across analyses.

    :class:`~repro_torch.core.task.RTTask` is a frozen dataclass, so the task object
    itself keys the cache: two analyses of the *same* task at the *same*
    allocation — even inside different task sets, priority orders, or
    controller epochs — reuse one workload-staircase construction.  This is
    the warm-start state the online scheduler threads through successive
    admissions (``RtgpuIncremental`` prefix state reused).

    ``fork()`` / ``adopt()`` give copy-on-success transactionality over the
    *decision-affecting* state: an admission test runs against a fork, and
    only a successful admission adopts the fork, so a rejected ``admit()``
    leaves the key set (and every analysis outcome) unchanged.  The fork is
    shallow — shared :class:`ViewTables` values may still warm their
    internal deterministic ``t → workload`` caches during a rejected test,
    which never changes any result.
    """

    def __init__(self) -> None:
        self.mem: dict[tuple, "ViewTables"] = {}
        self.cpu: dict[tuple, "ViewTables"] = {}
        # preemptive-GPU occupancy views, keyed (task, GN, ctx): the
        # context-switch overhead is baked into the staircase, so analyses
        # under different preemption configs never share a GPU view
        self.gpu: dict[tuple, "ViewTables"] = {}

    def fork(self) -> "AnalysisTables":
        child = AnalysisTables()
        child.mem = dict(self.mem)
        child.cpu = dict(self.cpu)
        child.gpu = dict(self.gpu)
        return child

    def adopt(self, other: "AnalysisTables") -> None:
        self.mem = other.mem
        self.cpu = other.cpu
        self.gpu = other.gpu

    def __len__(self) -> int:
        return len(self.mem) + len(self.cpu) + len(self.gpu)

    def fingerprint(self) -> tuple:
        """Hashable summary of the cache contents (for state-identity tests)."""
        return (frozenset(self.mem), frozenset(self.cpu), frozenset(self.gpu))


class RtgpuIncremental:
    """Incremental per-task RTGPU analysis with (task, GN) view caching.

    ``tightened=False`` (default) reproduces the paper's Theorem 5.6
    verbatim: R̂ = min(R̂1, R̂2).

    ``tightened=True`` additionally computes a sound beyond-paper bound R̂3
    and returns R̂ = min(R̂1, R̂2, R̂3).  Eq. 8's Σ MR̂ term charges every
    memory copy a *separate* worst-case bus-interference window; R̂3 instead
    bounds total bus interference jointly over the task's whole response
    window:  any higher-priority bus execution that delays one of our copies
    lies inside the end-to-end window, so its total is at most
    Σ_{hp} max_h MW_i^h(R̂3), and non-preemptive blocking is at most one
    lower-priority copy per own copy.  Hence

      R̂3 = Σ GR̂ + Σ ML̂ + Σ CL̂ + (2m−2)·B
            + Σ_{hp} max_h MW_i^h(R̂3) + Σ_{hp} max_h CW_i^h(R̂3)

    which is never looser than Eq. 8 (workload staircases are subadditive
    over window splits).  See EXPERIMENTS.md §Perf for the effect.
    """

    def __init__(
        self,
        taskset: TaskSet,
        tightened: bool = False,
        tables: "AnalysisTables | None" = None,
        preemption: "PreemptionModel | str | None" = None,
    ):
        self.taskset = taskset
        self.tightened = tightened
        self.preemption = PreemptionModel.coerce(preemption)
        # Bus blocking for task k: longest lower-priority copy (alloc-free).
        self._blocking = bus_blocking(taskset.tasks)
        # GPU blocking (preemptive arbitration only): one context switch
        # whenever any lower-priority task launches kernels (alloc-free).
        self._gpu_blocking = (
            gpu_blocking(taskset.tasks, self.preemption.ctx)
            if self.preemption.enabled else None
        )
        # Views are keyed by the (frozen, hashable) task itself so an external
        # AnalysisTables can be shared across task sets and priority orders.
        self._tables = tables if tables is not None else AnalysisTables()

    def mem_tables(self, i: int, gn: int) -> ViewTables:
        key = (self.taskset[i], gn)
        if key not in self._tables.mem:
            self._tables.mem[key] = ViewTables(mem_view(self.taskset[i], 2 * gn))
        return self._tables.mem[key]

    def cpu_tables(self, i: int, gn: int) -> ViewTables:
        key = (self.taskset[i], gn)
        if key not in self._tables.cpu:
            self._tables.cpu[key] = ViewTables(cpu_view(self.taskset[i], 2 * gn))
        return self._tables.cpu[key]

    def gpu_tables(self, i: int, gn: int) -> ViewTables:
        ctx = self.preemption.ctx
        key = (self.taskset[i], gn, ctx)
        if key not in self._tables.gpu:
            self._tables.gpu[key] = ViewTables(
                gpu_view(self.taskset[i], 2 * gn, ctx)
            )
        return self._tables.gpu[key]

    def analyze_task(self, k: int, alloc_prefix: Sequence[int]) -> TaskAnalysis:
        """Analyze task k given allocations for tasks 0..k (inclusive)."""
        if len(alloc_prefix) < k + 1:
            raise ValueError("need allocations for tasks 0..k")
        task = self.taskset[k]
        n_vsm = 2 * alloc_prefix[k]
        limit = task.deadline

        # GPU: dedicated federated units — Lemma 5.1.
        bounds = [g.response_bounds(n_vsm) for g in task.gpu]
        gpu_lo = tuple(b[0] for b in bounds)
        gpu_hi = tuple(b[1] for b in bounds)

        if self.preemption.enabled and task.n_gpu:
            # Priority-driven shared GPU (GCAPS-style): each kernel's
            # dedicated-speed bound is the base of a preemptive fixed point
            # over higher-priority GPU occupancy (each hp kernel inflated
            # by one context switch) plus the lower-priority blocking term.
            hp_gpu = [
                self.gpu_tables(i, alloc_prefix[i])
                for i in range(k)
                if self.taskset[i].n_gpu
            ]
            g_block = self._gpu_blocking[k]

            def interf_g(t: float) -> float:
                return sum(tb.max_workload(t) for tb in hp_gpu) + g_block

            gpu_hi = tuple(
                fixed_point(gpu_hi[j], interf_g, limit)
                for j in range(task.n_gpu)
            )

        hp_mem = [
            self.mem_tables(i, alloc_prefix[i])
            for i in range(k)
            if self.taskset[i].n_mem
        ]
        hp_cpu = [self.cpu_tables(i, alloc_prefix[i]) for i in range(k)]
        blocking = self._blocking[k]

        # Bus (Lemma 5.3): non-preemptive fixed priority with blocking.
        def interf_m(t: float) -> float:
            return sum(tb.max_workload(t) for tb in hp_mem) + blocking

        mem_resp = [fixed_point(task.mem_hi[j], interf_m, limit) for j in range(task.n_mem)]

        # CPU (Lemma 5.5): preemptive fixed priority.
        def interf_c(t: float) -> float:
            return sum(tb.max_workload(t) for tb in hp_cpu)

        cpu_resp = [fixed_point(task.cpu_hi[j], interf_c, limit) for j in range(task.m)]

        # End to end (Theorem 5.6).
        if any(map(math.isinf, mem_resp)) or any(map(math.isinf, cpu_resp)):
            r1 = _INF
        else:
            r1 = sum(gpu_hi) + sum(mem_resp) + sum(cpu_resp)

        if any(map(math.isinf, mem_resp)):
            r2 = _INF
        else:
            base2 = sum(gpu_hi) + sum(mem_resp) + task.cpu_total_hi()
            r2 = fixed_point(base2, interf_c, limit)

        if self.tightened:
            # Beyond-paper R̂3: joint bus+CPU interference over one window.
            base3 = (
                sum(gpu_hi)
                + task.mem_total_hi()
                + task.cpu_total_hi()
                + task.n_mem * blocking
            )

            def interf_joint(t: float) -> float:
                return sum(tb.max_workload(t) for tb in hp_mem) + sum(
                    tb.max_workload(t) for tb in hp_cpu
                )

            r3 = fixed_point(base3, interf_joint, limit)
            r2 = min(r2, r3)

        return TaskAnalysis(
            name=task.name or f"task{k}",
            n_vsm=n_vsm,
            gpu_resp_lo=gpu_lo,
            gpu_resp_hi=gpu_hi,
            mem_resp_hi=tuple(mem_resp),
            cpu_resp_hi=tuple(cpu_resp),
            r1=r1,
            r2=r2,
            deadline=task.deadline,
        )


def analyze_rtgpu(
    taskset: TaskSet,
    alloc: Sequence[int],
    preemption: "PreemptionModel | str | None" = None,
) -> SetAnalysis:
    """Full RTGPU schedulability analysis for a given virtual-SM allocation.

    ``alloc[i]`` is GN_i (physical SMs / chip-slices); each task gets
    ``2*GN_i`` virtual SMs (interleave lanes).  Priority order = index order
    of ``taskset`` (0 highest).  ``preemption`` selects the GPU arbitration
    model (default: the paper's dedicated federated slices).
    """
    if len(alloc) != len(taskset):
        raise ValueError("allocation length must match task count")
    inc = RtgpuIncremental(taskset, preemption=preemption)
    return SetAnalysis(
        tuple(inc.analyze_task(k, alloc) for k in range(len(taskset)))
    )


def analyze_rtgpu_plus(
    taskset: TaskSet,
    alloc: Sequence[int],
    preemption: "PreemptionModel | str | None" = None,
) -> SetAnalysis:
    """Beyond-paper variant: Theorem 5.6 plus the tightened joint bound R̂3."""
    if len(alloc) != len(taskset):
        raise ValueError("allocation length must match task count")
    inc = RtgpuIncremental(taskset, tightened=True, preemption=preemption)
    return SetAnalysis(
        tuple(inc.analyze_task(k, alloc) for k in range(len(taskset)))
    )
