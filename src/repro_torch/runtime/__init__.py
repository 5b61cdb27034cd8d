"""RT serving runtime: admission control and the bridge from a serving
engine's measured decode step to an RTGPU task.

admission.py   Algorithm-2 admission control (a copy of
               ``repro.runtime.admission``)
task_spec.py   serving job -> RTGPU (CL, ML, G) task chain, from the
               reference's constants or from measurements on the card
"""
from .admission import AdmissionController, AdmissionDecision
from .task_spec import ServingTaskSpec, serving_task_to_rt

__all__ = ["AdmissionController", "AdmissionDecision", "ServingTaskSpec",
           "serving_task_to_rt"]
