"""Bridge from a serving engine's measured decode step to an RTGPU task."""
from .task_spec import ServingTaskSpec, serving_task_to_rt

__all__ = ["ServingTaskSpec", "serving_task_to_rt"]
