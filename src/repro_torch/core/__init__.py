"""RTGPU task model (copies of ``repro.core.task`` and ``repro.core.interleave``)."""
from .interleave import (
    INTERLEAVE_RATIO_MAX,
    KERNEL_TYPES,
    VirtualSMModel,
    throughput_gain_total,
    throughput_gain_used,
)
from .task import GpuSegment, RTTask, SegmentKind, TaskSet, gpu_response_bounds

__all__ = [
    "GpuSegment",
    "RTTask",
    "SegmentKind",
    "TaskSet",
    "gpu_response_bounds",
    "INTERLEAVE_RATIO_MAX",
    "KERNEL_TYPES",
    "VirtualSMModel",
    "throughput_gain_total",
    "throughput_gain_used",
]
