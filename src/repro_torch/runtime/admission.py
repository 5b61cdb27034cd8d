"""Admission control: Algorithm 2 as a serving-cluster front door.

The controller owns ``gn_total`` accelerator slices per host (e.g. the
16-chip "model"-axis groups of the production mesh).  Under the default
``preemption="none"`` every admitted task gets a *dedicated*
(capacity-disjoint) slice allocation — federated, contention-free by
construction; with ``preemption="priority"`` admissions are certified
against GCAPS-style priority-preemptive GPU slices instead, so holdings
may overlap (each task's GN is bounded by the pool alone).  Either way
the full RTGPU analysis is re-verified on each admission and rejected
tasks leave the system state untouched.

Since the online-scheduling subsystem landed this is a thin wrapper over
:class:`repro_torch.sched.DynamicController` in *instant*-transition mode: the
front door admits before jobs exist, so allocation changes need no
job-boundary staging.  With ``hosts > 1`` the wrapper fronts a
:class:`repro_torch.sched.CapacityBroker` instead — global admission with
per-host rejection fallback over ``hosts`` identical instant-mode
controllers.  Either way the wrapper keeps the original one-shot API
(``admit`` / ``remove`` / ``current_taskset``) while inheriting the warm
paths — pinned 1-D admission search, hint + view-table reuse on the grid
fallback — so repeated admissions are far cheaper than re-running
Algorithm 2 cold (see ``benchmarks/churn_acceptance.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import FederatedResult, RTTask, TaskSet
from repro_torch.sched import CapacityBroker, DynamicController, EventTrace
from repro_torch.sched.journal import Journal

__all__ = ["AdmissionController", "AdmissionDecision"]


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    alloc: Optional[dict]          # task name -> GN_i slices (fleet-wide)
    reason: str = ""
    result: Optional[FederatedResult] = None
    host: Optional[int] = None     # admitting host (multi-host front doors)


class AdmissionController:
    def __init__(
        self,
        gn_total: int,
        tightened: bool = True,
        mode: str = "greedy+grid",
        max_candidates: int = 2000,
        trace: Optional[EventTrace] = None,
        engine: str = "batch",
        hosts: int = 1,
        placement: str = "least_loaded",
        preemption: str = "none",
        gpu_ctx_overhead: float = 0.0,
        durable=None,
    ):
        # ``mode`` is accepted for signature compatibility with the one-shot
        # controller but IGNORED: the dynamic controller always runs its
        # pinned warm path first and falls back to the hint-seeded grid
        # search, which dominates every legacy mode in both coverage and
        # latency.  ``engine`` selects the batched frontier analyzer
        # (default) or the scalar reference path ("scalar") underneath.
        # ``hosts > 1`` federates admission across that many identical
        # instant-mode controllers (``gn_total`` slices EACH) behind a
        # CapacityBroker with the given placement policy.  ``preemption``
        # selects the GPU arbitration model the admissions are certified
        # against ("none" = federated dedication, "priority" = GCAPS-style
        # preemptive slices with ``gpu_ctx_overhead`` per switch).
        # ``durable`` opts the front door into crash recovery: a journal
        # path (or a prebuilt repro_torch.sched.journal.Journal) makes every
        # admission/removal a write-ahead transaction, recoverable via
        # repro_torch.sched.recovery (the scheduler daemon fronts exactly this).
        # None (default) keeps the historical purely-in-memory behavior.
        self.gn_total = gn_total
        self.mode = mode
        self.hosts = hosts
        self._tightened = tightened
        if durable is None or isinstance(durable, Journal):
            self.journal: Optional[Journal] = durable
        else:
            self.journal = Journal(str(durable))
        if hosts > 1:
            self._dyn = None
            self._broker = CapacityBroker.build(
                hosts, gn_total,
                trace=trace,
                transition="instant",
                engine=engine,
                tightened=tightened,
                allow_realloc=True,
                max_candidates=max_candidates,
                placement=placement,
                preemption=preemption,
                gpu_ctx_overhead=gpu_ctx_overhead,
                journal=self.journal,
            )
        else:
            self._dyn = DynamicController(
                gn_total,
                tightened=tightened,
                transition="instant",
                allow_realloc=True,
                max_candidates=max_candidates,
                trace=trace,
                engine=engine,
                preemption=preemption,
                gpu_ctx_overhead=gpu_ctx_overhead,
                journal=self.journal,
            )
            self._broker = None

    @property
    def dynamic(self) -> DynamicController:
        """The underlying online controller (admission epochs, bounds);
        single-host front doors only."""
        if self._dyn is None:
            raise AttributeError(
                "multi-host front door has no single controller; use .broker"
            )
        return self._dyn

    @property
    def broker(self) -> CapacityBroker:
        """The underlying capacity broker (multi-host front doors only)."""
        if self._broker is None:
            raise AttributeError(
                "single-host front door has no broker; use .dynamic"
            )
        return self._broker

    @property
    def tasks(self) -> tuple[RTTask, ...]:
        ts = self.current_taskset()
        return tuple(ts.tasks) if ts else ()

    @property
    def allocation(self) -> dict:
        front = self._dyn if self._dyn is not None else self._broker
        return front.allocation

    def _host_result(self, ctl: DynamicController,
                     tried: int) -> Optional[FederatedResult]:
        """Re-attach the per-task analysis products of one host's decision
        (the one-shot controller's API).  The controller exposes the
        analysis it already certified (:meth:`DynamicController.
        set_analysis` — O(n) warm fixed points over its shared tables)."""
        ts = ctl.current_taskset()
        if ts is None:
            return None
        alloc = ctl.allocation
        alloc_list = tuple(alloc[t.name] for t in ts)
        return FederatedResult(True, alloc_list, ctl.set_analysis(), tried)

    def admit(self, task: RTTask) -> AdmissionDecision:
        if self._broker is not None:
            bdec = self._broker.admit(task)
            if not bdec.admitted:
                return AdmissionDecision(False, None, reason=bdec.reason)
            host = bdec.host
            result = self._host_result(self._broker.hosts[host],
                                       bdec.decision.tried)
            return AdmissionDecision(True, self._broker.allocation,
                                     result=result, host=host)
        dec = self._dyn.admit(task)
        if not dec.admitted:
            return AdmissionDecision(
                False, None,
                reason=dec.reason or
                "schedulability test failed under every allocation",
            )
        result = self._host_result(self._dyn, dec.tried)
        return AdmissionDecision(True, self._dyn.allocation, result=result)

    def remove(self, name: str) -> bool:
        if self._broker is not None:
            return self._broker.release(name)
        return self._dyn.release(name)

    def checkpoint(self) -> int:
        """Compact the journal (snapshot current state + truncate the
        log); returns the covered sequence number.  Durable front doors
        only — the daemon calls this on graceful shutdown and on its
        compaction cadence."""
        if self.journal is None:
            raise RuntimeError("checkpoint() needs a durable front door")
        from repro_torch.sched.recovery import serialize_state
        front = self._dyn if self._dyn is not None else self._broker
        return self.journal.checkpoint(serialize_state(front))

    def current_taskset(self) -> Optional[TaskSet]:
        front = self._dyn if self._dyn is not None else self._broker
        return front.current_taskset()

    def current_alloc_list(self) -> list[int]:
        ts = self.current_taskset()
        alloc = self.allocation
        return [alloc[t.name] for t in ts] if ts else []
