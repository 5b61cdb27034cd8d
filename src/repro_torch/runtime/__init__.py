"""RT serving runtime: admission control, the discrete-event engine and
its simulators, the wall-clock executor, and the bridge from a serving
engine's measured job to an RTGPU task.

admission.py   Algorithm-2 admission control (a copy of
               ``repro.runtime.admission``)
engine.py      the discrete-event engine (a copy of ``repro.runtime.engine``,
               with its ``REPRO_ENGINE`` variant switch)
simulator.py   simulate / simulate_churn / simulate_fleet over the engine
               (a copy of ``repro.runtime.simulator``)
record_golden.py  the golden-trace recorder (a copy)
executor.py    wall-clock executor of whole jobs on one host thread (a copy
               of ``repro.runtime.executor``); the port's engines run their
               jobs on the card under it (``ServingEngine.rt_service``)
task_spec.py   serving job -> RTGPU (CL, ML, G) task chain, from the
               reference's constants or from measurements on the card
"""
from .admission import AdmissionController, AdmissionDecision
from .engine import DiscreteEventEngine, EngineJob, SchedulingPolicy
from .executor import Service, WallClockExecutor
from .simulator import (
    ChurnSimResult,
    FleetSimResult,
    SimResult,
    simulate,
    simulate_churn,
    simulate_fleet,
)
from .task_spec import ServingTaskSpec, serving_task_to_rt

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "DiscreteEventEngine",
    "EngineJob",
    "SchedulingPolicy",
    "SimResult",
    "simulate",
    "ChurnSimResult",
    "simulate_churn",
    "FleetSimResult",
    "simulate_fleet",
    "ServingTaskSpec",
    "serving_task_to_rt",
    "Service",
    "WallClockExecutor",
]
