"""Synthetic taskset generation (paper §6.1, Table 1).

Procedure reproduced verbatim:
  1. draw per-task utilization U_i ~ Uniform, normalize to the target ΣU;
  2. draw CPU / memory / GPU segment lengths uniformly in their ranges
     (CPU [1,20] ms, mem [1,5] ms, GPU [1,20] ms by default; the ratio
     sweeps of Fig. 8 rescale mem/GPU ranges);
  3. D_i = (Σ CL̂ + Σ ML̂ + Σ GL̂) / U_i ;  T_i = D_i  (implicit deadline);
  4. deadline-monotonic priority assignment;
  5. GPU kernel-launch overhead ε = 12 % of the segment length; interleave
     ratio α per segment drawn from the Fig. 6 kernel-type maxima.

Execution-time *lower* bounds (the carons) use a variability knob:
``lo = hi * (1 - variability)``; variability=0 reproduces the
worst-case-execution-time model of Fig. 12, a positive value the
average-vs-worst gap of Fig. 13.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .interleave import INTERLEAVE_RATIO_MAX, KERNEL_TYPES
from .task import GpuSegment, RTTask, TaskSet

__all__ = [
    "GeneratorConfig",
    "generate_taskset",
    "generate_tasksets",
    "ChurnConfig",
    "ChurnEvent",
    "generate_churn_trace",
    "ScenarioPreset",
    "GOLDEN_SCENARIOS",
    "golden_scenario",
]


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """Table 1 defaults."""

    n_tasks: int = 5                     # N
    n_subtasks: int = 5                  # M -> m_i CPU segments per task
    cpu_range: tuple[float, float] = (1.0, 20.0)   # ms
    mem_range: tuple[float, float] = (1.0, 5.0)    # ms
    gpu_range: tuple[float, float] = (1.0, 20.0)   # ms (work at 1 SM)
    launch_overhead: float = 0.12        # ε: GL̂ = ε * GŴ
    copies: int = 2                      # 2-copy (Eq. 4) or combined 1-copy
    variability: float = 0.0             # lo = hi * (1 - variability)
    interleave: bool = True              # α per Fig. 6; 1.0 when disabled

    def scaled(self, cpu_mem_gpu_ratio: tuple[float, float, float]) -> "GeneratorConfig":
        """Rescale mem/GPU ranges relative to CPU, for the Fig. 8 sweeps.

        Ratio (a, b, c) keeps the CPU range and sets mem/GPU ranges to
        (b/a), (c/a) times it."""
        a, b, c = cpu_mem_gpu_ratio
        lo, hi = self.cpu_range
        return dataclasses.replace(
            self,
            mem_range=(lo * b / a, hi * b / a),
            gpu_range=(lo * c / a, hi * c / a),
        )


def _uniform_utils(rng: np.random.Generator, n: int, total: float) -> np.ndarray:
    u = rng.uniform(0.1, 1.0, size=n)
    return u / u.sum() * total


def generate_taskset(
    rng: np.random.Generator,
    total_util: float,
    config: GeneratorConfig = GeneratorConfig(),
) -> TaskSet:
    """One taskset at the given total utilization (paper normalization: one
    CPU + one bus + one SM fully busy <=> U = 1)."""
    utils = _uniform_utils(rng, config.n_tasks, total_util)
    tasks: list[RTTask] = []
    for i in range(config.n_tasks):
        m = config.n_subtasks
        cpu_hi = rng.uniform(*config.cpu_range, size=m)
        gpu_hi = rng.uniform(*config.gpu_range, size=m - 1)
        n_mem = config.copies * (m - 1)
        mem_hi = rng.uniform(*config.mem_range, size=n_mem)

        v = config.variability
        cpu_lo = cpu_hi * (1.0 - v)
        mem_lo = mem_hi * (1.0 - v)
        gpu_lo = gpu_hi * (1.0 - v)

        segs = []
        for j in range(m - 1):
            ktype = KERNEL_TYPES[int(rng.integers(len(KERNEL_TYPES)))]
            alpha = INTERLEAVE_RATIO_MAX[ktype] if config.interleave else 1.0
            segs.append(
                GpuSegment(
                    work_lo=float(gpu_lo[j]),
                    work_hi=float(gpu_hi[j]),
                    overhead_hi=float(config.launch_overhead * gpu_hi[j]),
                    alpha=float(alpha),
                )
            )

        # D_i = (Σ CL̂ + Σ ML̂ + Σ GL̂)/U_i with GL̂ the GPU segment length.
        span = float(cpu_hi.sum() + mem_hi.sum() + gpu_hi.sum())
        deadline = span / float(utils[i])
        tasks.append(
            RTTask(
                cpu_lo=tuple(cpu_lo),
                cpu_hi=tuple(cpu_hi),
                mem_lo=tuple(mem_lo),
                mem_hi=tuple(mem_hi),
                gpu=tuple(segs),
                deadline=deadline,
                period=deadline,
                copies=config.copies,
                name=f"tau{i}",
            )
        )
    return TaskSet.deadline_monotonic(tasks)


def generate_tasksets(
    seed: int,
    total_util: float,
    n_sets: int,
    config: GeneratorConfig = GeneratorConfig(),
) -> list[TaskSet]:
    rng = np.random.default_rng(seed)
    return [generate_taskset(rng, total_util, config) for _ in range(n_sets)]


# ---- sporadic arrival / departure traffic (online-scheduler churn) ----------


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Sporadic service arrival/departure model for the online scheduler.

    Services arrive as a Poisson process (exponential inter-arrival with
    mean ``mean_interarrival``), each carrying one Table-1-style task drawn
    at a per-service utilization ~ Uniform(*util_range*), and depart after
    a lifetime ~ Uniform(*lifetime_range*).  The result is an explicit
    admit/release event trace the dynamic controller and the churn
    simulator consume (``repro_torch.runtime.simulate_churn``).
    """

    mean_interarrival: float = 300.0           # ms between arrivals (mean)
    lifetime_range: tuple[float, float] = (1500.0, 4000.0)   # ms resident
    util_range: tuple[float, float] = (0.05, 0.15)           # per service
    task_config: GeneratorConfig = GeneratorConfig(n_subtasks=3)


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """One churn-trace entry: a service asking to join or leave at ``time``.

    ``kind`` is ``"admit"`` (with the service's RT task attached) or
    ``"release"``.  A release is a *request* to depart — the mode-change
    protocol reclaims the slices at the service's next job boundary.
    """

    time: float
    kind: str                       # "admit" | "release"
    name: str
    task: "RTTask | None" = None


def generate_churn_trace(
    seed: int,
    horizon: float,
    config: ChurnConfig = ChurnConfig(),
) -> list[ChurnEvent]:
    """Arrival/departure event trace over ``[0, horizon)``, time-sorted.

    Deterministic in ``seed``.  Every arrival inside the horizon gets a
    matching release event (possibly beyond the horizon — the simulator
    simply never reaches it), so admit/release events come in pairs."""
    rng = np.random.default_rng(seed)
    events: list[ChurnEvent] = []
    t = 0.0
    i = 0
    while True:
        t += float(rng.exponential(config.mean_interarrival))
        if t >= horizon:
            break
        u = float(rng.uniform(*config.util_range))
        cfg = dataclasses.replace(config.task_config, n_tasks=1)
        task = generate_taskset(rng, u, cfg)[0]
        name = f"svc{i}"
        task = dataclasses.replace(task, name=name)
        lifetime = float(rng.uniform(*config.lifetime_range))
        events.append(ChurnEvent(time=t, kind="admit", name=name, task=task))
        events.append(ChurnEvent(time=t + lifetime, kind="release", name=name))
        i += 1
    events.sort(key=lambda e: (e.time, e.name))
    return events


# ---- seeded scenario presets (golden-trace regression corpus) ---------------


@dataclasses.dataclass(frozen=True)
class ScenarioPreset:
    """One fully seeded simulator scenario, reproducible from parameters.

    ``kind="static"`` drives :func:`repro_torch.runtime.simulate` over one
    generated task set with the allocation found by Algorithm 2
    (deterministic even-split fallback when the draw is unschedulable, so
    miss-regime scenarios stay recordable).  ``kind="churn"`` drives
    :func:`repro_torch.runtime.simulate_churn` over a generated admit/release
    trace.  ``kind="fleet"`` drives :func:`repro_torch.runtime.simulate_fleet`
    over the same kind of trace, broker-routed across ``n_hosts`` hosts of
    ``gn_total`` slices each (the fleet presets).  The golden corpus under
    ``tests/golden/`` records one run per preset;
    ``python -m repro_torch.runtime.record_golden`` regenerates it.
    """

    name: str
    kind: str                              # "static" | "churn" | "fleet"
    seed: int
    horizon: float                         # simulated ms
    gn_total: int = 10                     # per host for kind="fleet"
    release_jitter: bool = True
    worst_case: bool = False
    description: str = ""
    # static scenarios
    total_util: float = 0.5
    config: GeneratorConfig = GeneratorConfig()
    # churn + fleet scenarios
    churn: ChurnConfig = ChurnConfig()
    churn_horizon: float = 0.0             # arrival-generation window
    # fleet scenarios
    n_hosts: int = 1
    placement: str = "least_loaded"
    imbalance_threshold: float = 0.25
    # GPU arbitration (all kinds): "none" = federated dedicated slices,
    # "priority" = preemptive priority-driven GPU context (GCAPS-style)
    preemption: str = "none"
    gpu_ctx_overhead: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in ("static", "churn", "fleet"):
            raise ValueError(f"unknown scenario kind {self.kind!r}")
        if self.preemption not in ("none", "priority"):
            raise ValueError(f"unknown preemption mode {self.preemption!r}")

    def build_static(self) -> tuple["TaskSet", list[int]]:
        """Task set + GN allocation (Algorithm 2; even split on failure).

        Certified under the preset's own arbitration model, so a static
        ``preemption="priority"`` preset never records an allocation whose
        bounds the priority-arbitrated engine can exceed."""
        from .federated import schedule
        from .rta import PreemptionModel, analyze_rtgpu_plus

        rng = np.random.default_rng(self.seed)
        ts = generate_taskset(rng, self.total_util, self.config)
        res = schedule(ts, self.gn_total, analyzer=analyze_rtgpu_plus,
                       mode="greedy+grid", max_candidates=2000,
                       preemption=PreemptionModel.coerce(
                           self.preemption, ctx=self.gpu_ctx_overhead))
        if res.schedulable:
            return ts, list(res.alloc)
        return ts, [max(1, self.gn_total // len(ts))] * len(ts)

    def build_churn(self) -> list[ChurnEvent]:
        """Admit/release trace for ``kind="churn"`` and ``kind="fleet"``."""
        return generate_churn_trace(self.seed, self.churn_horizon,
                                    config=self.churn)


#: The regression-corpus presets: steady, worst-case, near-critical
#: utilization, bus saturation, three churn regimes, preemptive-GPU churn,
#: and the multi-host fleet.  Names are the golden-file stems; changing a
#: preset's parameters requires deliberately re-recording its golden file.
GOLDEN_SCENARIOS: tuple[ScenarioPreset, ...] = (
    ScenarioPreset(
        name="steady", kind="static", seed=0, horizon=4000.0, gn_total=10,
        total_util=0.5, config=GeneratorConfig(variability=0.3),
        description="moderate utilization, sporadic jitter, varied runtimes",
    ),
    ScenarioPreset(
        name="steady_worst_case", kind="static", seed=2, horizon=3000.0,
        gn_total=10, total_util=0.4, release_jitter=False, worst_case=True,
        description="Fig. 12 regime: strictly periodic WCET execution",
    ),
    ScenarioPreset(
        name="near_critical", kind="static", seed=5, horizon=5000.0,
        gn_total=12, total_util=0.8,
        config=GeneratorConfig(variability=0.1),
        description="utilization near the admission boundary",
    ),
    ScenarioPreset(
        name="bus_saturated", kind="static", seed=1, horizon=9000.0,
        gn_total=12, total_util=0.7,
        config=GeneratorConfig(n_tasks=6,
                               variability=0.2).scaled((1.0, 3.0, 1.0)),
        description="memory-copy-heavy ratio: the PCIe bus is the bottleneck",
    ),
    ScenarioPreset(
        name="overload", kind="static", seed=9, horizon=4000.0,
        gn_total=6, total_util=2.2,
        config=GeneratorConfig(variability=0.1),
        description="beyond-critical utilization on the even-split fallback "
                    "allocation: deadline misses are expected and recorded",
    ),
    ScenarioPreset(
        name="churn_steady", kind="churn", seed=0, horizon=7000.0,
        gn_total=10, churn=ChurnConfig(), churn_horizon=6000.0,
        description="default Poisson service arrivals and departures",
    ),
    ScenarioPreset(
        name="churn_heavy", kind="churn", seed=4, horizon=6000.0,
        gn_total=8,
        churn=ChurnConfig(mean_interarrival=120.0,
                          lifetime_range=(400.0, 1200.0)),
        churn_horizon=5000.0,
        description="fast arrivals, short residencies: constant mode changes",
    ),
    ScenarioPreset(
        name="churn_worst_case", kind="churn", seed=3, horizon=5000.0,
        gn_total=8, release_jitter=False, worst_case=True,
        churn=ChurnConfig(), churn_horizon=4000.0,
        description="WCET churn: deterministic durations, periodic releases",
    ),
    ScenarioPreset(
        name="preemptive_churn", kind="churn", seed=1, horizon=5000.0,
        gn_total=4, preemption="priority", gpu_ctx_overhead=0.02,
        churn=ChurnConfig(mean_interarrival=150.0,
                          lifetime_range=(2500.0, 5000.0),
                          util_range=(0.03, 0.08),
                          task_config=GeneratorConfig(n_subtasks=3)),
        churn_horizon=4000.0,
        description="priority-preemptive GPU slices under capacity-bound "
                    "churn: overlapping slice holdings, kernel "
                    "preempt/resume hand-offs, context-switch overhead",
    ),
    ScenarioPreset(
        name="fleet_churn", kind="fleet", seed=0, horizon=7000.0,
        gn_total=6, n_hosts=3, placement="least_loaded",
        churn=ChurnConfig(mean_interarrival=150.0,
                          lifetime_range=(800.0, 2500.0)),
        churn_horizon=6000.0,
        description="3-host broker-routed churn: placement, per-host "
                    "rejection fallback, and departure-imbalance "
                    "migrations under the mode-change protocol",
    ),
)


def golden_scenario(name: str) -> ScenarioPreset:
    for preset in GOLDEN_SCENARIOS:
        if preset.name == name:
            return preset
    raise KeyError(f"no golden scenario named {name!r}")
