"""RTGPU core: the port's copies of the reference's scheduling library.

Layers (bottom-up), each a copy of the ``repro.core`` module of the same
name with ``repro.`` read as ``repro_torch.``:
  task.py        task model (Eq. 4) + Lemma 5.1 GPU response bounds
  workload.py    multi-segment self-suspension workload functions
  rta.py         fixed-point response-time analysis + Theorem 5.6
  federated.py   Algorithm 2 grid search / greedy allocation
  rta_batch.py   frontier-batched vectorized analysis (numpy engine; the
                 torch engine in place of the reference's JAX one)
  backend.py     backend selection for rta_batch ("numpy", "torch" on the
                 card, "torch:cpu")
  baselines.py   STGM busy-waiting and self-suspension baselines
  interleave.py  virtual-SM model, Fig. 6 ratios, Eqs. 9-10
  generator.py   task-set, churn-trace and golden-scenario generators
"""
from .task import GpuSegment, RTTask, SegmentKind, TaskSet, gpu_response_bounds
from .workload import (
    ResourceView,
    cpu_view,
    gpu_view,
    max_workload,
    mem_view,
    suspension_oblivious_view,
    workload_fn,
)
from .rta import (
    AnalysisTables,
    PreemptionModel,
    SetAnalysis,
    TaskAnalysis,
    analyze_rtgpu,
    analyze_rtgpu_plus,
    fixed_point,
)
from .federated import (
    FederatedResult,
    greedy_search,
    grid_search,
    grid_search_dfs,
    iter_allocations,
    min_viable_alloc,
    schedule,
)
from .rta_batch import BatchAnalyzer, grid_search_frontier
from .backend import available_backends, get_backend, set_backend
from .baselines import analyze_self_suspension, analyze_stgm
from .generator import (
    GOLDEN_SCENARIOS,
    ChurnConfig,
    ChurnEvent,
    GeneratorConfig,
    ScenarioPreset,
    generate_churn_trace,
    generate_taskset,
    generate_tasksets,
    golden_scenario,
)
from .interleave import (
    INTERLEAVE_RATIO_MAX,
    KERNEL_TYPES,
    VirtualSMModel,
    throughput_gain_total,
    throughput_gain_used,
)

__all__ = [
    "GpuSegment",
    "RTTask",
    "SegmentKind",
    "TaskSet",
    "gpu_response_bounds",
    "ResourceView",
    "cpu_view",
    "mem_view",
    "gpu_view",
    "suspension_oblivious_view",
    "workload_fn",
    "max_workload",
    "AnalysisTables",
    "PreemptionModel",
    "SetAnalysis",
    "TaskAnalysis",
    "analyze_rtgpu",
    "analyze_rtgpu_plus",
    "fixed_point",
    "FederatedResult",
    "grid_search",
    "grid_search_dfs",
    "grid_search_frontier",
    "BatchAnalyzer",
    "available_backends",
    "get_backend",
    "set_backend",
    "greedy_search",
    "schedule",
    "iter_allocations",
    "min_viable_alloc",
    "analyze_stgm",
    "analyze_self_suspension",
    "GeneratorConfig",
    "generate_taskset",
    "generate_tasksets",
    "ChurnConfig",
    "ChurnEvent",
    "generate_churn_trace",
    "ScenarioPreset",
    "GOLDEN_SCENARIOS",
    "golden_scenario",
    "INTERLEAVE_RATIO_MAX",
    "KERNEL_TYPES",
    "VirtualSMModel",
    "throughput_gain_total",
    "throughput_gain_used",
]
