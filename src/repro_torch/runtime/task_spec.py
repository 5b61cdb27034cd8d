"""Bridging model serving to the RTGPU task model.

A :class:`ServingTaskSpec` describes one model serving periodic inference
requests with a hard deadline.  :func:`serving_task_to_rt` turns it into an
RTGPU task:

  CPU segments     host pre/post-processing (tokenize / detokenize /
                   sampling) — estimated ms,
  memory segments  host↔device transfer of the request tokens and result
                   logits over PCIe (non-preemptive, single channel),
  GPU segment      one decode step: GW = step time × one interleave lane
                   (so Lemma 5.1's GW/(2GN) reproduces the step time),
                   GL = collective+dispatch critical path, α from the
                   step's dominant-resource kernel type (Fig. 6 table).

On the card, ``roofline_step_s`` is the decode step the serving engine
measured with CUDA events.  Without it the step falls back to a bound on
reading the logits, at ``hbm_bw`` bytes/s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import INTERLEAVE_RATIO_MAX, GpuSegment, RTTask
from repro_torch.roofline import HBM_BW

__all__ = ["ServingTaskSpec", "serving_task_to_rt"]

PCIE_BW = 16e9          # bytes/s host<->device
HOST_TOKENIZE_US_PER_TOK = 0.3
HOST_SAMPLE_US = 120.0


@dataclasses.dataclass(frozen=True)
class ServingTaskSpec:
    name: str
    arch_id: str
    period_ms: float
    deadline_ms: float
    batch: int
    seq_len: int                 # context length per request
    new_tokens: int = 1          # decode steps per request (m-1 GPU segments)
    roofline_step_s: Optional[float] = None  # decode step time (whole card)
    collective_s: float = 0.0
    dominant: str = "compute_s"  # dominant term -> kernel type
    vocab: int = 32000
    variability: float = 0.2


_DOMINANT_TO_KTYPE = {
    "compute_s": "compute",
    "memory_s": "memory",
    "collective_s": "branch",   # interconnect-bound ~ irregular/branch class
}


def serving_task_to_rt(spec: ServingTaskSpec, hbm_bw: float = HBM_BW) -> RTTask:
    """Derive the (CL, ML, G) chain for one request-serving job."""
    m = spec.new_tokens + 1  # CPU segments: pre + per-token post/sample
    # CPU: tokenize once, then sample/detokenize per generated token
    pre_ms = spec.batch * spec.seq_len * HOST_TOKENIZE_US_PER_TOK / 1000.0
    post_ms = spec.batch * HOST_SAMPLE_US / 1000.0 / 1000.0 * 1000.0
    cpu_hi = [max(pre_ms, 0.05)] + [max(post_ms, 0.05)] * (m - 1)

    # memory copies: tokens in (first), logits out (each step) — 2-copy model
    in_bytes = spec.batch * spec.seq_len * 4
    out_bytes = spec.batch * spec.vocab * 2
    ml_in = max(in_bytes / PCIE_BW * 1000.0, 0.01)
    ml_out = max(out_bytes / PCIE_BW * 1000.0, 0.01)
    mem_hi = []
    for _ in range(m - 1):
        mem_hi.extend([ml_in, ml_out])

    # accelerator: one decode step per generated token
    ktype = _DOMINANT_TO_KTYPE.get(spec.dominant, "compute")
    alpha = INTERLEAVE_RATIO_MAX[ktype]
    step_s = spec.roofline_step_s
    if step_s is None:
        # fallback: bandwidth-bound decode estimate
        step_s = spec.batch * spec.vocab * 2 / hbm_bw
    gw_ms = step_s * 1000.0 * 2.0  # GW at ONE virtual lane (2 lanes/SM)
    gl_ms = max(spec.collective_s * 1000.0, 0.02)
    gpu = [
        GpuSegment(
            work_lo=gw_ms * (1 - spec.variability),
            work_hi=gw_ms,
            overhead_hi=gl_ms,
            alpha=alpha,
        )
        for _ in range(m - 1)
    ]

    v = spec.variability
    return RTTask(
        cpu_lo=tuple(c * (1 - v) for c in cpu_hi),
        cpu_hi=tuple(cpu_hi),
        mem_lo=tuple(x * (1 - v) for x in mem_hi),
        mem_hi=tuple(mem_hi),
        gpu=tuple(gpu),
        deadline=spec.deadline_ms,
        period=spec.period_ms,
        copies=2,
        name=spec.name,
    )
