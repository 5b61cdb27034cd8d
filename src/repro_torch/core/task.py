"""RT-GPU task model (paper §5.1).

A task is an alternating chain of CPU, memory-copy and accelerator (GPU)
segments::

    two-copy model (paper Eq. 4, c=2):
        CL0, ML0, G0, ML1, CL1, ML2, G1, ML3, CL2, ... , CL(m-1)
    one-copy model (paper §6.1 second model, c=1):
        CL0, ML0, G0, CL1, ML1, G1, ... , CL(m-1)

with ``m`` CPU segments, ``m-1`` GPU segments and ``c*(m-1)`` memory-copy
segments.  Every length is an interval ``[lo, hi]`` (the paper's caron / hat
accents).  GPU segments carry the Lemma-5.1 triple ``(GW, GL, alpha)``.

A "virtual SM" is one of the two interleave lanes that
``kernels/persistent_matmul`` pins to each allocated SM.

A copy of ``repro.core.task``: the PyTorch port keeps its own.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np

__all__ = [
    "SegmentKind",
    "GpuSegment",
    "RTTask",
    "TaskSet",
    "gpu_response_bounds",
]


class SegmentKind(enum.Enum):
    CPU = "cpu"
    MEM = "mem"
    GPU = "gpu"


@dataclasses.dataclass(frozen=True)
class GpuSegment:
    """Accelerator kernel segment ``G = (GW, GL, alpha)`` (paper §5.1).

    ``work``          total work C      — interval [work_lo, work_hi]
    ``overhead_hi``   critical path L̂   — kernel-launch + on-chip overhead
    ``alpha``         interleave ratio  — execution inflation in [1.0, 1.8]
    """

    work_lo: float
    work_hi: float
    overhead_hi: float
    alpha: float = 1.0

    def __post_init__(self) -> None:
        if not (0.0 <= self.work_lo <= self.work_hi):
            raise ValueError(f"bad GPU work interval [{self.work_lo}, {self.work_hi}]")
        if self.overhead_hi < 0.0:
            raise ValueError("negative critical-path overhead")
        if self.alpha < 1.0:
            raise ValueError(f"interleave ratio must be >= 1, got {self.alpha}")

    def response_bounds(self, n_vsm: int) -> tuple[float, float]:
        """Lemma 5.1 response-time bounds on ``n_vsm = 2*GN_i`` virtual SMs."""
        return gpu_response_bounds(
            self.work_lo, self.work_hi, self.overhead_hi, self.alpha, n_vsm
        )


def gpu_response_bounds(
    work_lo: float,
    work_hi: float,
    overhead_hi: float,
    alpha: float,
    n_vsm: int,
) -> tuple[float, float]:
    """Lemma 5.1:  GR̆ = GW̆ / 2GN ;  GR̂ = (GŴ·α − GL̂)/2GN + GL̂.

    The upper bound is clamped at GL̂ (the critical path is a floor: the
    formula can dip below it for tiny kernels where GŴ·α < GL̂).
    """
    if n_vsm < 1:
        raise ValueError("need at least one virtual SM")
    lo = work_lo / n_vsm
    hi = (work_hi * alpha - overhead_hi) / n_vsm + overhead_hi
    hi = max(hi, overhead_hi, lo)
    return lo, hi


@dataclasses.dataclass(frozen=True)
class RTTask:
    """One sporadic CPU–mem–GPU task (paper Eq. 4).

    ``cpu_lo/cpu_hi``  shape (m,)           CPU segment execution bounds
    ``mem_lo/mem_hi``  shape (c*(m-1),)     memory-copy bounds, in chain order
    ``gpu``            length m-1           GPU segments
    ``deadline``       D_i  (constrained: D <= T)
    ``period``         T_i
    ``copies``         c in {1, 2}          memory copies per GPU segment
    """

    cpu_lo: tuple[float, ...]
    cpu_hi: tuple[float, ...]
    mem_lo: tuple[float, ...]
    mem_hi: tuple[float, ...]
    gpu: tuple[GpuSegment, ...]
    deadline: float
    period: float
    copies: int = 2
    name: str = ""

    def __post_init__(self) -> None:
        m = len(self.cpu_hi)
        if m < 1:
            raise ValueError("task needs at least one CPU segment")
        if len(self.cpu_lo) != m:
            raise ValueError("cpu_lo/cpu_hi length mismatch")
        if len(self.gpu) != m - 1:
            raise ValueError(f"expected {m - 1} GPU segments, got {len(self.gpu)}")
        if self.copies not in (1, 2):
            raise ValueError("copies must be 1 or 2")
        n_mem = self.copies * (m - 1)
        if len(self.mem_lo) != n_mem or len(self.mem_hi) != n_mem:
            raise ValueError(f"expected {n_mem} memory segments")
        if any(l > h for l, h in zip(self.cpu_lo, self.cpu_hi)):
            raise ValueError("cpu_lo > cpu_hi")
        if any(l > h for l, h in zip(self.mem_lo, self.mem_hi)):
            raise ValueError("mem_lo > mem_hi")
        if not (0 < self.deadline <= self.period):
            raise ValueError(
                f"constrained deadline required: 0 < D={self.deadline} <= T={self.period}"
            )

    # ---- structural helpers -------------------------------------------------

    @property
    def m(self) -> int:
        """Number of CPU segments (the paper's m_i)."""
        return len(self.cpu_hi)

    @property
    def n_mem(self) -> int:
        return len(self.mem_hi)

    @property
    def n_gpu(self) -> int:
        return len(self.gpu)

    def chain(self) -> list[tuple[SegmentKind, int]]:
        """The segment chain as (kind, index-within-kind) pairs."""
        seq: list[tuple[SegmentKind, int]] = []
        mi = 0
        for j in range(self.m - 1):
            seq.append((SegmentKind.CPU, j))
            seq.append((SegmentKind.MEM, mi))
            mi += 1
            seq.append((SegmentKind.GPU, j))
            if self.copies == 2:
                seq.append((SegmentKind.MEM, mi))
                mi += 1
        seq.append((SegmentKind.CPU, self.m - 1))
        return seq

    # ---- aggregate bounds ---------------------------------------------------

    def cpu_total_hi(self) -> float:
        return float(sum(self.cpu_hi))

    def mem_total_hi(self) -> float:
        return float(sum(self.mem_hi))

    def gpu_response_totals(self, n_vsm: int) -> tuple[float, float]:
        lo = hi = 0.0
        for g in self.gpu:
            l, h = g.response_bounds(n_vsm)
            lo += l
            hi += h
        return lo, hi

    def min_span(self, n_vsm: int) -> float:
        """Best-case end-to-end time — a lower bound used for pruning."""
        glo, _ = self.gpu_response_totals(n_vsm)
        return float(sum(self.cpu_lo) + sum(self.mem_lo) + glo)

    def wcet_busy(self, n_vsm: int) -> float:
        """Busy-waiting WCET (STGM view): everything charged to the CPU."""
        _, ghi = self.gpu_response_totals(n_vsm)
        return self.cpu_total_hi() + self.mem_total_hi() + ghi

    def utilization(self, n_vsm: int = 2) -> float:
        return self.wcet_busy(n_vsm) / self.period


@dataclasses.dataclass(frozen=True)
class TaskSet:
    """A priority-ordered task set (index 0 = highest priority)."""

    tasks: tuple[RTTask, ...]

    def __post_init__(self) -> None:
        if not self.tasks:
            raise ValueError("empty task set")

    def __len__(self) -> int:
        return len(self.tasks)

    def __iter__(self):
        return iter(self.tasks)

    def __getitem__(self, i: int) -> RTTask:
        return self.tasks[i]

    @staticmethod
    def deadline_monotonic(tasks: Sequence[RTTask]) -> "TaskSet":
        """Order tasks by deadline-monotonic priority (paper Table 1)."""
        return TaskSet(tuple(sorted(tasks, key=lambda t: t.deadline)))

    def total_utilization(self, n_vsm: int = 2) -> float:
        return float(sum(t.wcet_busy(n_vsm) / t.period for t in self.tasks))

    def as_arrays(self) -> dict[str, np.ndarray]:
        """Dense padded arrays (used by the vectorized analysis)."""
        n = len(self.tasks)
        m_max = max(t.m for t in self.tasks)
        nm_max = max(t.n_mem for t in self.tasks)
        ng_max = m_max - 1
        out = {
            "m": np.array([t.m for t in self.tasks], np.int32),
            "copies": np.array([t.copies for t in self.tasks], np.int32),
            "deadline": np.array([t.deadline for t in self.tasks], np.float64),
            "period": np.array([t.period for t in self.tasks], np.float64),
            "cpu_lo": np.zeros((n, m_max)),
            "cpu_hi": np.zeros((n, m_max)),
            "mem_lo": np.zeros((n, nm_max)),
            "mem_hi": np.zeros((n, nm_max)),
            "gpu_work_lo": np.zeros((n, ng_max)),
            "gpu_work_hi": np.zeros((n, ng_max)),
            "gpu_overhead_hi": np.zeros((n, ng_max)),
            "gpu_alpha": np.ones((n, ng_max)),
        }
        for i, t in enumerate(self.tasks):
            out["cpu_lo"][i, : t.m] = t.cpu_lo
            out["cpu_hi"][i, : t.m] = t.cpu_hi
            out["mem_lo"][i, : t.n_mem] = t.mem_lo
            out["mem_hi"][i, : t.n_mem] = t.mem_hi
            for j, g in enumerate(t.gpu):
                out["gpu_work_lo"][i, j] = g.work_lo
                out["gpu_work_hi"][i, j] = g.work_hi
                out["gpu_overhead_hi"][i, j] = g.overhead_hi
                out["gpu_alpha"][i, j] = g.alpha
        return out
