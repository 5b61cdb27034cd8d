"""Virtual-SM interleaved-execution model (paper §4.3–4.4, Fig. 6, Eqs. 9–10).

Each physical compute unit exposes two *virtual* units (interleave lanes);
running two resident blocks inflates per-block latency by the interleave
ratio α but improves total throughput whenever α < 2.  The paper measures
α per kernel type (Fig. 6); with *self-interleaving* a kernel only ever
co-runs with itself, so α is a per-task constant — the property the hard
RT bounds rely on.

A "kernel type" maps to the dominant resource of a model step —
tensor-core-bound (compute), HBM-bound (memory), gather-bound (branch) and
transcendental/softmax-heavy (special).  The ratios below are the paper's
measured maxima (GTX 1080Ti), used by the runtime's step-time model until
the port measures α on the H100.

A copy of ``repro.core.interleave``: the PyTorch port keeps its own.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

__all__ = [
    "KERNEL_TYPES",
    "INTERLEAVE_RATIO_MAX",
    "VirtualSMModel",
    "throughput_gain_total",
    "throughput_gain_used",
]

KERNEL_TYPES: tuple[str, ...] = ("compute", "memory", "branch", "special")

# Fig. 6 maxima: "at most 1.45x, 1.7x, 1.7x, and 1.8x for special, branch,
# memory and computation kernels".
INTERLEAVE_RATIO_MAX: Mapping[str, float] = {
    "compute": 1.8,
    "memory": 1.7,
    "branch": 1.7,
    "special": 1.45,
}


@dataclasses.dataclass(frozen=True)
class VirtualSMModel:
    """2 virtual units per physical unit, with per-type latency inflation."""

    n_physical: int
    ratios: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: dict(INTERLEAVE_RATIO_MAX)
    )

    @property
    def n_virtual(self) -> int:
        return 2 * self.n_physical

    def alpha(self, kernel_type: str) -> float:
        return float(self.ratios[kernel_type])

    def interleaved_time(self, base_time: float, kernel_type: str) -> float:
        """Latency of one lane when both lanes of a unit are busy."""
        return base_time * self.alpha(kernel_type)

    def speedup(self, kernel_type: str) -> float:
        """Throughput gain of interleaving vs. serial:  2/α  (>1 iff α<2)."""
        return 2.0 / self.alpha(kernel_type)


def throughput_gain_total(
    sms_per_task: Sequence[int],
    alphas: Sequence[float],
    gn_total: int,
) -> float:
    """Paper Eq. 9 — η₁, improvement normalized over the whole accelerator."""
    if len(sms_per_task) != len(alphas):
        raise ValueError("length mismatch")
    return sum(
        (sm / gn_total) * (2.0 / a - 1.0) for sm, a in zip(sms_per_task, alphas)
    )


def throughput_gain_used(
    sms_per_task: Sequence[int],
    alphas: Sequence[float],
) -> float:
    """Paper Eq. 10 — η₂, improvement normalized over the SMs actually used."""
    used = sum(sms_per_task)
    if used == 0:
        return 0.0
    return sum(
        (sm / used) * (2.0 / a - 1.0) for sm, a in zip(sms_per_task, alphas)
    )
