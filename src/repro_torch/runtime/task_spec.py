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

``serving_task_to_rt`` keeps the reference's arithmetic (its tests hold
it to the JAX function): ``roofline_step_s`` is one step's time, and
without it the step falls back to a bound on reading the logits, at
``hbm_bw`` bytes/s.  It takes the whole step as GPU work, host time
included.

:func:`measured_task_to_rt` builds the task from the card instead: the
GPU segment from the device-busy decode step measured at several SM
counts and fitted by :func:`fit_step` (Fig. 4's t(m) = (C−L)/m + L), the
prefill's wall added to the first CPU segment and a host share per step
added to each decode token's, so the task bounds the whole job
``ServingEngine.generate`` runs: one prefill, then ``new_tokens`` decode
steps.  A :class:`DecodeCalibration` holds those measurements for one job
shape, whole jobs' walls among them; ``ServingEngine.rt_register`` takes
them on the card and admits the task they give.

The host's part of a job has no bound to measure, only samples, so it
enters the task as a probabilistic WCET (:func:`pwcet_ms`): the extreme
value fit of measurement-based probabilistic timing analysis (a Gumbel
distribution fitted to the maxima of blocks of jobs), read at a stated
exceedance probability per job, one SM count at a time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import (INTERLEAVE_RATIO_MAX, GpuSegment, RTTask, TaskSet,
                              analyze_rtgpu_plus)
from repro_torch.roofline import HBM_BW

__all__ = ["ServingTaskSpec", "serving_task_to_rt", "StepFit", "fit_step",
           "measured_task_to_rt", "pwcet_ms", "lag1", "runs_test", "independence",
           "DecodeCalibration", "job_response_ms"]

PCIE_BW = 16e9          # bytes/s host<->device
HOST_TOKENIZE_US_PER_TOK = 0.3
HOST_SAMPLE_US = 120.0
PWCET_BLOCK = 8         # consecutive calibration jobs whose largest wall is one maximum
PWCET_EXCEEDANCE = 1e-3  # probability per job that its wall exceeds the pWCET


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


@dataclasses.dataclass(frozen=True)
class StepFit:
    """Upper envelope t(m) <= a_ms / m + l_ms of the device-busy decode
    step t(m), in ms, measured on m SMs (``sms``, ``device_ms``)."""

    sms: tuple[int, ...]
    device_ms: tuple[float, ...]
    a_ms: float
    l_ms: float


def fit_step(sms: Sequence[int], device_ms: Sequence[float]) -> StepFit:
    """Fit Fig. 4's t(m) = A/m + L to the device-busy step at three or more
    SM counts, then raise L until the curve bounds every measured point.

    Least squares in 1/m gives the slope A (clamped at 0: a step that does
    not shrink with more SMs has no parallel part); L is the least value
    with t(m) <= A/m + L at every m."""
    sms = tuple(int(m) for m in sms)
    t = np.asarray(device_ms, dtype=np.float64)
    if len(set(sms)) < 3 or len(sms) != len(t):
        raise ValueError(f"need the step at three or more SM counts, got {sms}")
    inv = 1.0 / np.asarray(sms, dtype=np.float64)
    a = max(float(np.polyfit(inv, t, 1)[0]), 0.0)
    l_ms = max(float(np.max(t - a * inv)), 0.0)
    return StepFit(sms, tuple(float(x) for x in t), a, l_ms)


def measured_task_to_rt(spec: ServingTaskSpec, fit: StepFit, host_step_ms: float,
                        prefill_ms: float) -> RTTask:
    """The serving job's task from measurements on the card.

    GPU segment per decode token: GL̂ = L and GŴ = 2A + L from ``fit``, so
    that Lemma 5.1's GR̂ on 2m virtual SMs, (GŴα − GL̂)/2m + GL̂ =
    Aα/m + L(α−1)/2m + L, is at least the envelope A/m + L >= t(m) at every
    measured m (α >= 1).  CPU segment per decode token: sampling's
    estimate plus ``host_step_ms``, the host's share of a step.  First CPU
    segment: the tokenize estimate plus
    ``prefill_ms``, the prefill's wall (the largest measured), so the
    chain keeps ``len(gpu) == new_tokens`` and still bounds the prefill.
    The memory copies, α and the deadline and period are
    ``serving_task_to_rt``'s."""
    base = serving_task_to_rt(spec)
    gw_ms = 2.0 * fit.a_ms + fit.l_ms
    v = spec.variability
    gpu = tuple(dataclasses.replace(seg, work_lo=gw_ms * (1 - v), work_hi=gw_ms,
                                    overhead_hi=fit.l_ms) for seg in base.gpu)
    cpu_hi = ((base.cpu_hi[0] + prefill_ms,)
              + tuple(c + host_step_ms for c in base.cpu_hi[1:]))
    return dataclasses.replace(base, cpu_lo=tuple(c * (1 - v) for c in cpu_hi),
                               cpu_hi=cpu_hi, gpu=gpu)


def pwcet_ms(walls: Sequence[float]) -> float:
    """The wall that one more job exceeds with probability
    ``PWCET_EXCEEDANCE``: a Gumbel distribution fitted by its moments to the
    maxima of blocks of ``PWCET_BLOCK`` consecutive ``walls``, read where a
    block's maximum exceeds it with probability 1 − (1 −
    PWCET_EXCEEDANCE)^PWCET_BLOCK; never below the largest wall.  Needs two
    blocks or more."""
    x = np.asarray(walls, dtype=np.float64)
    n = len(x) // PWCET_BLOCK
    if n < 2:
        raise ValueError(f"need two blocks of {PWCET_BLOCK} walls, got {len(x)} walls")
    maxima = x[:n * PWCET_BLOCK].reshape(n, PWCET_BLOCK).max(axis=1)
    beta = float(np.std(maxima, ddof=1)) * math.sqrt(6.0) / math.pi
    mu = float(np.mean(maxima)) - np.euler_gamma * beta
    p_block = -math.expm1(PWCET_BLOCK * math.log1p(-PWCET_EXCEEDANCE))
    return max(mu - beta * math.log(-math.log1p(-p_block)), float(x.max()))


def lag1(walls: Sequence[float]) -> float:
    """Lag-1 autocorrelation of ``walls`` in the order given."""
    x = np.asarray(walls, dtype=np.float64)
    d = x - x.mean()
    return float(np.dot(d[:-1], d[1:]) / np.dot(d, d))


def runs_test(walls: Sequence[float]) -> dict:
    """Wald-Wolfowitz runs of ``walls`` above and below their median (walls
    equal to it dropped): the runs, the runs expected of independent walls,
    z and the two-sided p."""
    x = np.asarray(walls, dtype=np.float64)
    above = x[x != np.median(x)] > np.median(x)
    n1, n2 = int(above.sum()), int((~above).sum())
    runs = 1 + int(np.count_nonzero(above[1:] != above[:-1]))
    n = n1 + n2
    expected = 2.0 * n1 * n2 / n + 1.0
    var = 2.0 * n1 * n2 * (2.0 * n1 * n2 - n) / (n * n * (n - 1))
    z = (runs - expected) / math.sqrt(var) if var > 0 else math.nan
    return {"runs": runs, "expected": expected, "z": z, "p": math.erfc(abs(z) / math.sqrt(2))}


def independence(walls: Sequence[float]) -> dict:
    """What :func:`pwcet_ms` assumes of its walls, in their timing order:
    :func:`lag1` and :func:`runs_test`."""
    return {"lag1": lag1(walls), **runs_test(walls)}


@dataclasses.dataclass
class DecodeCalibration:
    """The job of one shape ([batch, seq_len] prompts, ``new_tokens``
    decode steps) measured on the card.  ``measured[m]`` holds, with the
    pinned matmuls on m SMs, each prefill's wall (``prefill_ms``), each
    decode step's device-busy time (``device_ms``) and each whole job's
    wall (``job_ms``, one ``ServingEngine.generate`` each, in the order
    timed), in ms.  Only the first calibration times whole jobs; a count
    measured later (a granted GN) has none, so a refit cannot move the
    host's part of R̂.

    The task splits a job in three.  CPU segment 0 carries the largest
    prefill wall of every count; each GPU segment bounds a decode step's
    device-busy time at GN.  What neither covers is the host's part: a
    job's wall at m less a lower bound of its device part at m, the
    smallest prefill wall there plus ``new_tokens`` times the smallest
    device-busy step there (:meth:`device_lower_ms`,
    :meth:`host_parts_ms`).  Its pWCET is fitted to one SM count's jobs at
    a time (:func:`pwcet_ms`), and the largest over the counts
    (:meth:`host_bound_ms`), since the task is built before GN is known,
    is spread evenly over the decode CPU segments (:meth:`host_step_ms`).  So segment 0, the GPU segments and the host
    bound together cover a job's wall at any calibrated count."""

    batch: int
    seq_len: int
    new_tokens: int
    measured: dict[int, dict]

    @property
    def shape(self) -> tuple[int, int, int]:
        return self.batch, self.seq_len, self.new_tokens

    @property
    def job_ms(self) -> tuple[float, ...]:
        """Every whole job's wall, count after count in the order measured."""
        return tuple(w for row in self.measured.values() for w in row["job_ms"])

    def fit(self, without: Optional[int] = None) -> StepFit:
        """The fit of each m's largest device-busy step, leaving out the
        points of ``without`` if given."""
        sms = sorted(m for m in self.measured if m != without)
        return fit_step(sms, [max(self.measured[m]["device_ms"]) for m in sms])

    def prefill_ms(self) -> float:
        """The largest prefill wall over every measured SM count."""
        return max(max(row["prefill_ms"]) for row in self.measured.values())

    def device_lower_ms(self, m: int) -> float:
        """A lower bound of one job's device part on m SMs: the smallest
        prefill wall plus ``new_tokens`` times the smallest device-busy
        decode step measured there.  Where the row says how many device
        activities each step's profile recorded (``device_activities``),
        only the complete profiles count: a profile that lost activities
        undercounts the step's device time."""
        row = self.measured[m]
        busy, seen = row["device_ms"], row.get("device_activities")
        if seen:
            busy = [ms for ms, n in zip(busy, seen) if n == max(seen)]
        return min(row["prefill_ms"]) + self.new_tokens * min(busy)

    def host_parts_ms(self, m: int) -> np.ndarray:
        """The host's part of each whole job timed on m SMs, in timing
        order: its wall less :meth:`device_lower_ms`."""
        return np.asarray(self.measured[m]["job_ms"], dtype=np.float64) - self.device_lower_ms(m)

    def host_pwcets_ms(self) -> dict[int, float]:
        """Each SM count's pWCET of the host's part, from that count's jobs
        alone; counts without whole jobs are left out."""
        return {m: pwcet_ms(self.host_parts_ms(m))
                for m, row in self.measured.items() if row["job_ms"]}

    def host_bound_ms(self) -> float:
        """The host's part of one job: the largest of :meth:`host_pwcets_ms`."""
        pwcets = self.host_pwcets_ms()
        if not pwcets:
            raise ValueError("no SM count of the calibration has whole jobs timed")
        return max(pwcets.values())

    def host_step_ms(self) -> float:
        """Each decode token's share of :meth:`host_bound_ms`, at least 0."""
        return max(self.host_bound_ms(), 0.0) / self.new_tokens

    def task(self, spec: ServingTaskSpec, without: Optional[int] = None) -> RTTask:
        """``spec``'s task from these measurements (:func:`measured_task_to_rt`)."""
        shape = (spec.batch, spec.seq_len, spec.new_tokens)
        if shape != self.shape:
            raise ValueError(f"{spec.name}: job shape {shape}, calibrated {self.shape}")
        return measured_task_to_rt(spec, self.fit(without), self.host_step_ms(),
                                   self.prefill_ms())

    def gr_hi(self, spec: ServingTaskSpec, m: int, held_out: bool = False) -> float:
        """The GPU segment's GR̂ on m SMs (2m virtual SMs), in ms; with
        ``held_out``, from the fit without m's own points: the model's
        prediction at a count it was not fitted on."""
        task = self.task(spec, without=m if held_out else None)
        return task.gpu[0].response_bounds(2 * m)[1]


def job_response_ms(task: RTTask, gn: int) -> float:
    """The whole job's R̂ alone on ``gn`` SMs, in ms (inf past its
    deadline, where the analysis stops)."""
    return float(analyze_rtgpu_plus(TaskSet((task,)), [gn]).tasks[0].response)
