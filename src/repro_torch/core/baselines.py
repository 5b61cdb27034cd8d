"""Baseline schedulability tests the paper compares against (§6.1).

1. **STGM** [38] — persistent threads + *busy-waiting*: the CPU core is held
   during memory copies and GPU execution, so a task's whole body is CPU
   demand.  Classic uniprocessor response-time analysis with a blocking term
   for the non-preemptive bus.

2. **Self-suspension** [47][23] — the multi-segment self-suspension analysis
   with *opaque* suspensions.  Per the paper's §6.2.1 critique, "the
   suspension does not distinguish between the memory segments and GPU
   segments. Instead, they are modelled as non-preemptive and will block
   higher priority tasks": the whole ML–G–ML region of a task is one
   non-preemptive hold of a single shared suspension resource, so GPU time
   (which RTGPU isolates via federated SMs) re-enters the serial contention.
   Concretely, suspension chunks are analysed like Lemma 5.3 executions on
   one serial device (with lower-priority chunk blocking), and the CPU side
   uses Lemma 2.2/2.3 with the chunk *response times* as suspensions.

Both baselines still use persistent-thread SM partitioning (GR bounds from
Lemma 5.1) and both get the same allocation search, so the comparison
isolates the *analysis*, exactly as in the paper's Figs. 8–11.
"""
from __future__ import annotations

import math
from typing import Sequence

from .rta import SetAnalysis, TaskAnalysis, fixed_point
from .task import RTTask, TaskSet
from .workload import ResourceView, ViewTables, suspension_oblivious_view

__all__ = ["analyze_stgm", "analyze_self_suspension"]

_INF = math.inf


# --------------------------------------------------------------------------
# STGM: busy-waiting
# --------------------------------------------------------------------------

def analyze_stgm(taskset: TaskSet, alloc: Sequence[int]) -> SetAnalysis:
    """Busy-waiting analysis: C_i = Σ CL̂ + Σ ML̂ + Σ GR̂(2GN_i); classic
    R = C_k + B_k + Σ_{hp} ⌈R/T_i⌉ C_i with bus blocking B_k."""
    n = len(taskset)
    n_vsm = [2 * g for g in alloc]
    wcet = [t.wcet_busy(n_vsm[i]) for i, t in enumerate(taskset)]

    results = []
    for k, task in enumerate(taskset):
        blocking = 0.0
        for i in range(k + 1, n):
            if taskset[i].n_mem:
                blocking = max(blocking, max(taskset[i].mem_hi))

        def interf(t: float) -> float:
            return sum(
                math.ceil(t / taskset[i].period) * wcet[i] for i in range(k)
            )

        r = fixed_point(wcet[k] + blocking, interf, task.deadline)
        glo, ghi = task.gpu_response_totals(n_vsm[k])
        results.append(
            TaskAnalysis(
                name=task.name or f"task{k}",
                n_vsm=n_vsm[k],
                gpu_resp_lo=(glo,),
                gpu_resp_hi=(ghi,),
                mem_resp_hi=(),
                cpu_resp_hi=(r,),
                r1=r,
                r2=r,
                deadline=task.deadline,
            )
        )
    return SetAnalysis(tuple(results))


# --------------------------------------------------------------------------
# Self-suspension with suspension-oblivious (lumped mem+GPU) serialization
# --------------------------------------------------------------------------

def _suspension_chunks_hi(task: RTTask, n_vsm: int) -> list[float]:
    """Upper bound of each contiguous mem-GPU(-mem) suspension region."""
    his: list[float] = []
    for j in range(task.m - 1):
        _, ghi = task.gpu[j].response_bounds(n_vsm)
        if task.copies == 2:
            hi = task.mem_hi[2 * j] + ghi + task.mem_hi[2 * j + 1]
        else:
            hi = task.mem_hi[j] + ghi
        his.append(hi)
    return his


def _chunk_lo(task: RTTask, n_vsm: int, j: int) -> float:
    glo, _ = task.gpu[j].response_bounds(n_vsm)
    if task.copies == 2:
        return task.mem_lo[2 * j] + glo + task.mem_lo[2 * j + 1]
    return task.mem_lo[j] + glo


def _device_view(task: RTTask, n_vsm: int) -> ResourceView:
    """Suspension chunks as execution segments on one shared serial device.

    This encodes the §6.2.1 critique: the baseline's analysis "does not
    distinguish between the memory segments and GPU segments", so the whole
    ML–G(–ML) region of every task contends on one serial non-preemptive
    resource, and "the GPU segments in one task" DO interfere with other
    tasks' (unlike RTGPU's federated SMs).

    Gaps between chunk j and j+1 = CL̆_{j+1}; head/tail = CL̆_0 / CL̆_{m-1}."""
    chunk_hi = _suspension_chunks_hi(task, n_vsm)
    gaps = [task.cpu_lo[j] for j in range(1, task.m - 1)]
    head = task.cpu_lo[0]
    tail = task.cpu_lo[task.m - 1]
    first_wrap = max(0.0, task.period - task.deadline + tail + head)
    steady_wrap = max(0.0, task.period - sum(chunk_hi) - sum(gaps))
    return ResourceView(
        exec_hi=tuple(chunk_hi),
        gap_lo=tuple(gaps),
        first_wrap=first_wrap,
        steady_wrap=steady_wrap,
        period=task.period,
    )


def analyze_self_suspension(taskset: TaskSet, alloc: Sequence[int]) -> SetAnalysis:
    """Suspension-oblivious baseline ([23] machinery, Lemmas 2.1–2.3):
    CPU segments via fixed-priority RTA; opaque mem+GPU suspension chunks
    contending on one serial non-preemptive device; end-to-end via
    Lemma 2.3 with chunk *responses* as suspension lengths."""
    n = len(taskset)
    n_vsm = [2 * g for g in alloc]
    cpu_tabs = [
        ViewTables(suspension_oblivious_view(t, n_vsm[i]))
        for i, t in enumerate(taskset)
    ]
    dev_tabs = [
        ViewTables(_device_view(t, n_vsm[i])) if t.n_gpu else None
        for i, t in enumerate(taskset)
    ]

    results = []
    for k, task in enumerate(taskset):
        limit = task.deadline

        # --- suspension chunks on the shared serial device ------------------
        hp_dev = [dev_tabs[i] for i in range(k) if dev_tabs[i] is not None]
        dev_blocking = 0.0
        for i in range(k + 1, n):
            if taskset[i].n_gpu:
                chunks = _suspension_chunks_hi(taskset[i], n_vsm[i])
                dev_blocking = max(dev_blocking, max(chunks))

        def interf_d(t: float) -> float:
            return sum(tb.max_workload(t) for tb in hp_dev) + dev_blocking

        own_chunks_hi = _suspension_chunks_hi(task, n_vsm[k])
        chunk_resp = [fixed_point(c, interf_d, limit) for c in own_chunks_hi]

        # --- CPU segments (Lemma 2.2) ---------------------------------------
        hp_cpu = cpu_tabs[:k]

        def interf_c(t: float) -> float:
            return sum(tb.max_workload(t) for tb in hp_cpu)

        cpu_resp = [fixed_point(task.cpu_hi[j], interf_c, limit) for j in range(task.m)]

        # --- end to end (Lemma 2.3 with chunk responses as suspensions) -----
        if any(map(math.isinf, chunk_resp)) or any(map(math.isinf, cpu_resp)):
            r1 = _INF
        else:
            r1 = sum(chunk_resp) + sum(cpu_resp)

        if any(map(math.isinf, chunk_resp)):
            r2 = _INF
        else:
            base2 = sum(chunk_resp) + task.cpu_total_hi()
            r2 = fixed_point(base2, interf_c, limit)

        glo, ghi = task.gpu_response_totals(n_vsm[k])
        results.append(
            TaskAnalysis(
                name=task.name or f"task{k}",
                n_vsm=n_vsm[k],
                gpu_resp_lo=(glo,),
                gpu_resp_hi=(ghi,),
                mem_resp_hi=tuple(chunk_resp),
                cpu_resp_hi=tuple(cpu_resp),
                r1=r1,
                r2=r2,
                deadline=task.deadline,
            )
        )
    return SetAnalysis(tuple(results))
